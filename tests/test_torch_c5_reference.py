"""BASELINE config 5 as the benchmark commits it (`portbench/configs/
c5_long10k.json`, `portbench/traffic/snp2_any_strand.json`, the limits of
`portbench/cells/c5_long10k_split.json`), cut in size only: one CPU run of
the port's CLI over 10 kb reads split past 1,500 bp against the ancestor it
infers, judged by the benchmark's plain reference.  A sound run keeps within
every limit; the same run with the ancestor widened to every copy's bases
does not."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run
from portbench.reference import align, ancestor, judge, sam

REPO = Path(__file__).resolve().parent.parent
PORTBENCH = REPO / "portbench"
SEED = 2**31 + 2020
# the sizes cut as portbench/tests/conftest.shrink cuts them; the widths
# (read length, split size, the copies' number and SNP rate) stay
REFERENCE_LENGTH, SEGMENT, READS = 200_000, 10_000, 12


def _committed(kind: str, name: str) -> dict:
    return json.loads((PORTBENCH / kind / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def c5_run(tmp_path_factory):
    """(the sample, one CLI run's outputs, the committed cell's limits)."""
    config = _committed("configs", "c5_long10k")
    assert config["reads"]["length"] == 10_000 and config["reads"]["split_past"] == 1500
    assert config["reference"]["repeats"]["copies"] == 3 and config["outputs"] == ["sam", "ancestor"]
    config["reference"]["length"] = REFERENCE_LENGTH
    config["reference"]["repeats"]["segment"] = SEGMENT
    config["reads"]["count"] = READS
    cell = SimpleNamespace(config=config, traffic=_committed("traffic", "snp2_any_strand"))
    work = tmp_path_factory.mktemp("c5")
    sample = run.make_sample(cell, SEED, work)
    (work / "out").mkdir()
    from mapper_tpu_torch import cli

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
        mp.delenv("MAPPER_TPU_TRACE", raising=False)
        assert cli.main(run.cli_argv(config, sample.files, work / "out", work / "cache")) == 0
    outputs = {name: (work / "out" / run.OUTPUT_FILES[name]).read_text() for name in config["outputs"]}
    return sample, outputs, _committed("cells", "c5_long10k_split")["limits"]


def test_a_sound_run_keeps_within_the_committed_limits(c5_run):
    sample, outputs, limits = c5_run
    numbers, missing = judge.assess(sample, outputs, "cpu")
    assert set(numbers) <= set(limits)
    assert all(value <= limits[name] for name, value in numbers.items()), numbers
    assert numbers["ancestor_faults"] == 0 and missing == 0
    rows = {line.split("\t")[0] for line in outputs["sam"].splitlines() if not line.startswith("@")}
    assert rows == set(judge.units(sample)[0].names) and len(rows) == 7 * READS


def test_an_ancestor_widened_to_every_copys_bases_is_not_correct(c5_run):
    sample, outputs, limits = c5_run
    name, codes = ancestor.parse_fasta(outputs["ancestor"])[0]
    planted = sample.planted
    union = np.bitwise_or.reduce(np.stack([sample.ref[s : s + planted.segment] for s in planted.starts]), axis=0)
    codes = codes.copy()
    for s in planted.starts:
        codes[s : s + planted.segment] |= union
    letters = np.zeros(16, dtype=np.uint8)
    for letter, code in ancestor.IUPAC.items():
        letters[code] = ord(letter)
    widened = f">{name}\n{letters[codes].tobytes().decode()}\n"
    numbers, _ = judge.assess(sample, {**outputs, "ancestor": widened}, "cpu")
    assert numbers["ancestor_faults"] > limits["ancestor_faults"]
    assert not all(value <= limits[k] for k, value in numbers.items())


def test_rows_moved_to_another_copy_are_not_correct(c5_run):
    """Each row inside a planted copy or its source moved to the same offset
    in the next copy, its AS:f the penalty there: sound rows placed in the
    wrong copy, which only `penalty_gap` and `reads_above_optimum` see (at
    this size about ten pieces move, so `penalty_gap` is the one past its
    limit)."""
    sample, outputs, limits = c5_run
    _, checked = ancestor.judge(outputs["ancestor"], sample.ref, sample.contig, sample.planted)
    starts, segment = list(sample.planted.starts), sample.planted.segment
    lines, moved = [], 0
    for line in outputs["sam"].splitlines():
        f = line.split("\t")
        if not line.startswith("@"):
            pos = int(f[3]) - 1
            k = next((i for i, s in enumerate(starts) if s <= pos and pos + 2 * len(f[9]) < s + segment), None)
            if k is not None:
                f[3] = str(starts[(k + 1) % len(starts)] + pos - starts[k] + 1)
                penalty = sam.row_penalties(sam.parse("\t".join(f)), checked, sample.contig,
                                            align.penalties(sample.config))[0]
                f[-1] = f"AS:f:{np.float32(penalty / align.SCALE)}"
                moved += 1
        lines.append("\t".join(f))
    numbers, _ = judge.assess(sample, {**outputs, "sam": "\n".join(lines) + "\n"}, "cpu")
    assert moved > 0 and numbers["bad_rows"] == 0 and numbers["missing_reads"] == 0
    assert numbers["reads_above_optimum"] >= 0.8 * moved
    assert not all(value <= limits[k] for k, value in numbers.items())
