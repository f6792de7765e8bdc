"""`python -m mapper_tpu_torch` against `python -m mapper_tpu` on the same
FASTA/FASTQ inputs: every output file byte-identical.  The port runs its
batch engine on the CPU (MAPPER_TPU_TORCH_DEVICE=cpu), where the scorer is the
plain PyTorch version of the CUDA kernels."""

import numpy as np
import pytest

from benchmarks.simlib import random_reference, rc_text, write_reference
from mapper_tpu import cli as jax_cli
from mapper_tpu_torch import cli as torch_cli
from mapper_tpu_torch.simulate import simulate_reads, write_fastq

OUTPUTS = {
    "--out-sam": "out.sam",
    "--out-vcf": "out.vcf",
    "--out-mutations": "mutations.txt",
    "--out-refs-map-count": "refs.txt",
    "--out-unaligned": "unaligned.fastq",
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_inputs")
    rng = np.random.default_rng(99)
    ref = random_reference(rng, 40_000)
    write_reference(str(root / "ref.fasta"), {"chrA": ref[:25_000], "chrB": ref[25_000:]})
    reads = simulate_reads(rng, ref, 300, 150, snp_rate=0.01, indel_fraction=0.2)
    reads += [(f"u{i}", random_reference(rng, 150)) for i in range(8)]  # unalignable
    write_fastq(root / "reads.fastq", reads)
    mates1, mates2 = [], []
    for i in range(60):
        pos = int(rng.integers(0, 24_000 - 400))
        frag = ref[pos : pos + int(rng.integers(300, 360))]
        mates1.append((f"p{i}/1", frag[:100]))
        mates2.append((f"p{i}/2", rc_text(frag[-100:])))
    write_fastq(root / "m1.fastq", mates1)
    write_fastq(root / "m2.fastq", mates2)
    return root


def _run(main, inputs, out_dir, query_args):
    out_dir.mkdir()
    args = ["--reference", str(inputs / "ref.fasta"), *query_args, "--devices", "1"]
    for flag, name in OUTPUTS.items():
        args += [flag, str(out_dir / name)]
    assert main(args) == 0
    return {name: (out_dir / name).read_bytes() for name in OUTPUTS.values()}


@pytest.mark.parametrize("kind", ["single", "paired", "exact"])
def test_cli_outputs_byte_identical(monkeypatch, tmp_path, inputs, kind):
    monkeypatch.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
    if kind == "single":
        query_args = ["--queries", str(inputs / "reads.fastq")]
    elif kind == "exact":  # the sequential engine: host code on both sides
        query_args = ["--queries", str(inputs / "reads.fastq"), "--engine", "exact"]
    else:
        query_args = [
            "--paired-queries", str(inputs / "m1.fastq"), str(inputs / "m2.fastq"),
            "--spacing", "100", "50",
        ]
    want = _run(jax_cli.main, inputs, tmp_path / "jax", query_args)
    got = _run(torch_cli.main, inputs, tmp_path / "torch", query_args)
    for name in OUTPUTS.values():
        assert got[name] == want[name], name
    assert got["out.sam"].count(b"\n") > 60
    if kind != "paired":
        assert got["unaligned.fastq"].count(b"@u") == 8


@pytest.mark.parametrize(
    "extra,env",
    [
        (["--devices", "2"], {}),
        (["--num-processes", "2"], {}),
        (["--coordinator", "localhost:1234"], {}),
    ],
)
def test_cli_rejects_what_is_not_ported(monkeypatch, tmp_path, inputs, extra, env):
    monkeypatch.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = [
        "--reference", str(inputs / "ref.fasta"), "--queries", str(inputs / "reads.fastq"),
        "--out-sam", str(tmp_path / "out.sam"), *extra,
    ]
    with pytest.raises(SystemExit) as e:
        torch_cli.main(args)
    assert e.value.code != 0
