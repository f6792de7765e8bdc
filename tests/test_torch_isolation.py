"""The port runs without JAX, and fails loudly where it cannot run: no
kernel build without nvcc, no CPU fallback for a CUDA run without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mapper_tpu_torch.align import banded, kernels

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "mapper_tpu_torch"

_NO_JAX_RUN = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np, torch
import mapper_tpu_torch, mapper_tpu_torch.cli, mapper_tpu_torch.align.kernels
from mapper_tpu_torch import Api, AlignmentParameters
from mapper_tpu_torch.batch.engine import BatchAligner
from benchmarks.simlib import random_reference
from mapper_tpu_torch.simulate import simulate_reads
from mapper_tpu.align.query import Query
from mapper_tpu.sequence import Sequence

rng = np.random.default_rng(0)
ref = random_reference(rng, 8000)
index = Api.new_database({"chr1": ref})
reads = simulate_reads(rng, ref, 16, 100)
engine = BatchAligner(index, AlignmentParameters.defaults(), torch.device("cpu"))
results = engine.process_batch([Query(Sequence.from_text(n, t)) for n, t in reads])
aligned = sum(1 for r in results if r is not None and any(r.get_alignments()))
assert aligned >= 14, aligned
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.") or m.startswith("jaxlib")]
print("OK", aligned)
"""


def test_imports_and_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


_JAX_MODULES = (
    "jax",
    "jaxlib",
    "mapper_tpu.align.pallas_dp",
    "mapper_tpu.batch.engine",
    "mapper_tpu.batch.device_candidates",
    "mapper_tpu.batch.device_pileup",
    "mapper_tpu.parallel",
)


def test_no_jax_import_in_port_sources():
    """No module of the port, nor chip_smoke.py, imports jax or a module of
    the JAX package that imports it."""
    sources = list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                for bad in _JAX_MODULES:
                    assert name != bad and not name.startswith(bad + "."), (path, name)


_NO_JAX_PROBES_AND_PILEUP = r"""
import contextlib, io, os, sys, tempfile
sys.modules["jax"] = None  # any import of jax now raises ImportError
from pathlib import Path
import numpy as np
from mapper_tpu_torch import cli
from mapper_tpu_torch.probe_i16.__main__ import main as probe_main
from benchmarks.simlib import random_reference, write_reference
from mapper_tpu_torch.simulate import simulate_reads, write_fastq

os.environ["MAPPER_TPU_TORCH_DEVICE"] = "cpu"
for stage in "abcdefghi":
    assert probe_main([stage]) == 0, stage
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
ref = random_reference(rng, 8000)
write_reference(str(root / "ref.fasta"), {"chr1": ref})
write_fastq(root / "reads.fastq", simulate_reads(rng, ref, 40, 100))
os.environ["MAPPER_TPU_DEVICE_PILEUP"] = "1"
err = io.StringIO()
with contextlib.redirect_stderr(err):
    rc = cli.main(["--reference", str(root / "ref.fasta"), "--queries", str(root / "reads.fastq"),
                   "--out-vcf", str(root / "out.vcf"), "--out-mutations", str(root / "mut.txt")])
assert rc == 0
assert "Device pileup:" in err.getvalue(), err.getvalue()[-2000:]
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.") or m.startswith("jaxlib")]
print("OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_probes_and_device_pileup_run_with_jax_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_PROBES_AND_PILEUP], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("OK")
    assert proc.stdout.count(": OK") == 40


def test_probe_entry_cuda_without_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = _env()
    env["MAPPER_TPU_TORCH_DEVICE"] = "cuda"
    proc = subprocess.run(
        [sys.executable, "-m", "mapper_tpu_torch.probe_i16", "g"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert ": OK" not in proc.stdout


def test_library_key_covers_the_shared_header(monkeypatch, tmp_path):
    """The build is keyed by every source and header: editing dp_core.cuh,
    which both sources include, names another library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in kernels.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    real = kernels.library_path(tmp_path)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    assert kernels.library_path(tmp_path) == real
    assert [p.name for p in kernels.sources()] == ["banded_dp.cu", "probe_i16.cu"]
    header = csrc / "dp_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernels.library_path(tmp_path) != real


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library(tmp_path)
    assert not list(tmp_path.iterdir())


def test_kernel_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        kernels.library(tmp_path / "build")


def test_scorer_has_no_other_device_branch():
    meta = torch.device("meta")
    args = [torch.zeros((2, 64), dtype=torch.uint8, device=meta)] + [
        torch.zeros(4, dtype=torch.int64, device=meta) for _ in range(7)
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        banded.banded_scores_gathered(*args, None, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.banded_i16(*[a.to("cpu") for a in banded._normalize(*[
            torch.zeros((2, 64), dtype=torch.uint8)] + [torch.zeros(4, dtype=torch.int64)] * 7
        )], (30, 1, 63, 18, 60, 15), 1 / 30, 32)


def test_cli_cuda_without_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (tmp_path / "ref.fasta").write_text(">chr1\n" + "ACGT" * 500 + "\n")
    (tmp_path / "reads.fasta").write_text(">r1\n" + "ACGT" * 25 + "\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["MAPPER_TPU_TORCH_DEVICE"] = "cuda"
    proc = subprocess.run(
        [sys.executable, "-m", "mapper_tpu_torch", "--reference", str(tmp_path / "ref.fasta"),
         "--queries", str(tmp_path / "reads.fasta"), "--out-sam", str(tmp_path / "out.sam")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "out.sam").exists()
