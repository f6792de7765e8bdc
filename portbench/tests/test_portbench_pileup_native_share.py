"""cli.pileup_native_share, the share of a job's component alignments that
the native pileup pass took (counters `pileup.native` over
`pileup.alignments` in the program's `[trace]` line): read on a traced CPU
run of each cell, computed by hand, and silent (None) where the program
counts no pileup alignments."""

import json
from types import SimpleNamespace

import pytest

from portbench import cells, run
from portbench.tests.conftest import REPO

NAME = "cli.pileup_native_share"


def _read(stderrs):
    ctx = SimpleNamespace(jobs=[SimpleNamespace(stderr=s, stdout="") for s in stderrs], reads_per_job=2000,
                          spans=SimpleNamespace(spans=[("job", 10.0, 20.0)]), device=None, config={})
    return cells.reader(REPO, NAME)(ctx)


def _stderr(counts):
    record = {"clock": "perf_counter", "spans": [["cli.main", "MainThread", 10.0, 20.0, 9.0, None, None]],
              "counts": counts}
    return "Loading reference\n[trace] " + json.dumps(record) + "\nDone\n"


BASE = {"reads.single": 2000, "rows.candidates": 9000, "rows.device": 2000}


@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_every_alignment_takes_the_native_pass_in_a_traced_cpu_run(tiny_root, workload):
    result = run.run_cell(tiny_root, workload, 2**31 + 11, 1, True, "cpu")
    assert result["correct"]
    assert result["metrics"][NAME]["value"] == 1.0


@pytest.mark.parametrize("jobs, share", [
    ([(2100, 2100), (2100, 2100)], 1.0),
    ([(2100, 0), (2100, 0)], 0.0),
    ([(2000, 2000), (1000, 0)], 2000 / 3000),  # summed over the window's jobs
])
def test_the_reader_by_hand(jobs, share):
    stderrs = [_stderr(dict(BASE, **{"pileup.alignments": a, "pileup.native": n})) for a, n in jobs]
    assert _read(stderrs) == pytest.approx(share)


@pytest.mark.parametrize("stderr", [
    _stderr(BASE),                                  # a program without the counters
    "Align phase: 2000 queries in 1.0s\n",          # a program without the line
    "[trace] {not json\n",                          # a broken line
])
def test_a_program_without_the_counters_gives_nothing(stderr):
    assert _read([stderr]) is None
