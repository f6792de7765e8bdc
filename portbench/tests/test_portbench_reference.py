"""The reference agrees with a tiny CLI run on the CPU and rejects outputs
corrupted after it."""

import contextlib
import io
import re

import pytest

from portbench import cells, generate, run
from portbench.reference import judge


@pytest.fixture(scope="module", params=["se150_gapped", "pe150_gapped"])
def cli_run(request, tmp_path_factory):
    """One CPU CLI run of a cell at the tests' size: (sample, outputs, best)."""
    from portbench.tests.conftest import copy_bench, shrink

    root = copy_bench(tmp_path_factory.mktemp("root"))
    shrink(root)
    cell = cells.load(root, request.param)
    run.environment(root, "cpu")
    from mapper_tpu_torch import cli

    work = tmp_path_factory.mktemp("work")
    sample = run.make_sample(cell, 2**31 + 99, work)
    (work / "out").mkdir()
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(run.cli_argv(cell.config, sample.files, work / "out", work / "cache")) == 0
    outputs = {name: (work / "out" / run.OUTPUT_FILES[name]).read_text() for name in cell.config["outputs"]}
    return sample, outputs, judge.optimum(sample, "cpu")


def numbers(cli_run, **changed):
    sample, outputs, best = cli_run
    return judge._judge(sample, {**outputs, **changed}, best, sample.ref)[0]


def test_reference_agrees_with_the_cli(cli_run):
    got = numbers(cli_run)
    summary = "mutation_lines_differing" if "mutations" in cli_run[1] else "vcf_lines_differing"
    assert got == {"bad_rows": 0, "missing_reads": 0, "penalty_gap": 0.0, "reads_above_optimum": 0, summary: 0}


def _rows(text):
    lines = text.splitlines(keepends=True)
    body = [i for i, line in enumerate(lines) if not line.startswith("@")]
    return lines, body


def test_a_moved_row_is_caught(cli_run):
    lines, body = _rows(cli_run[1]["sam"])
    f = lines[body[0]].split("\t")
    f[3] = str(int(f[3]) + 1)
    lines[body[0]] = "\t".join(f)
    assert numbers(cli_run, sam="".join(lines))["bad_rows"] >= 1


def test_a_wrong_score_is_caught(cli_run):
    lines, body = _rows(cli_run[1]["sam"])
    lines[body[5]] = re.sub(r"AS:f:[0-9.]+", "AS:f:0.0", lines[body[5]]) if "AS:f:0.0" not in lines[body[5]] \
        else lines[body[5]].replace("AS:f:0.0", "AS:f:1.0")
    assert numbers(cli_run, sam="".join(lines))["bad_rows"] >= 1


def test_dropped_rows_are_caught(cli_run):
    lines, body = _rows(cli_run[1]["sam"])
    kept = [line for i, line in enumerate(lines) if i not in set(body[::2])]
    got = numbers(cli_run, sam="".join(kept))
    assert got["missing_reads"] >= len(body) // 4
    summary = "mutation_lines_differing" if "mutations" in cli_run[1] else "vcf_lines_differing"
    assert got[summary] >= 1


def test_a_corrupted_summary_is_caught(cli_run):
    name = "mutations" if "mutations" in cli_run[1] else "vcf"
    lines = cli_run[1][name].splitlines(keepends=True)
    k = next(i for i, line in enumerate(lines) if not line.startswith(("#", "CHR\t")))
    f = lines[k].split("\t")
    f[4] = "7"  # a depth
    lines[k] = "\t".join(f)
    got = numbers(cli_run, **{name: "".join(lines)})
    assert got[f"{'mutation' if name == 'mutations' else 'vcf'}_lines_differing"] == 2


def test_a_worse_alignment_is_caught(cli_run):
    """A row moved to another alignment of its read that is sound but worse
    than the optimum: a reversed read aligned where a mismatch is added."""
    sample, outputs, best = cli_run
    lines, body = _rows(outputs["sam"])
    i = next(i for i in body if lines[i].split("\t")[5] == "150M" and "AS:f:0.0" in lines[i])
    f = lines[i].split("\t")
    seq = list(f[9])
    seq[75] = {"A": "C", "C": "G", "G": "T", "T": "A"}[seq[75]]
    ref_base = generate.decode(sample.ref[int(f[3]) - 1 + 75 : int(f[3]) + 75])
    assert ref_base != seq[75]
    # the read itself must change for the row to stay its read's, so judge a
    # sample whose read is the mutated one against the original optimum
    k = next(j for reads in sample.reads for j, n in enumerate(reads.names) if n == f[0])
    reads = next(r for r in sample.reads if f[0] in r.names)
    text = "".join(seq)
    if reads.reverse[k]:
        text = generate.decode(generate.reverse_complement(generate.encode(text)))
    old = reads.texts[k]
    reads.texts[k] = text
    try:
        f[9] = "".join(seq)
        f[-1] = "AS:f:1.0\n"
        lines[i] = "\t".join(f)
        got = judge._judge(sample, {**outputs, "sam": "".join(lines)}, best, sample.ref)[0]
    finally:
        reads.texts[k] = old
    assert got["penalty_gap"] == 1.0 and got["reads_above_optimum"] == 1 and got["bad_rows"] == 0
