"""dupscan.native_share, the share of the rows the two-copy duplication scan
gathered that its native pass grouped (counters `dupscan.native_rows` over
`dupscan.rows` in the program's `[trace]` line): read on a shrunk traced
CPU run of `c5_long10k_split`, the one cell that scans inside its window,
computed by hand, and silent (None) where the program counts no row."""

import json
from types import SimpleNamespace

import pytest

from portbench import cells, run
from portbench.tests.conftest import REPO

NAME = "dupscan.native_share"
WORKLOAD = "c5_long10k_split"


def _read(stderrs):
    ctx = SimpleNamespace(jobs=[SimpleNamespace(stderr=s, stdout="") for s in stderrs], reads_per_job=2000,
                          spans=SimpleNamespace(spans=[("job", 10.0, 40.0)]), device=None, config={})
    return cells.reader(REPO, NAME)(ctx)


def _stderr(counts):
    record = {"clock": "perf_counter", "spans": [["cli.main", "MainThread", 10.0, 40.0, 25.0, None, None]],
              "counts": counts}
    return "Loading reference\n[trace] " + json.dumps(record) + "\nDone\n"


BASE = {"split.reads": 2000, "split.pieces": 14000, "ancestry.duplications": 120}


def test_the_metric_is_listed_for_the_cell_that_scans_in_its_window():
    assert [m["name"] for m in cells.load(REPO, WORKLOAD).per_layer][-1] == NAME
    for workload in ("se150_gapped", "pe150_gapped"):
        assert NAME not in [m["name"] for m in cells.load(REPO, workload).per_layer]


def test_every_row_takes_the_native_pass_in_a_shrunk_traced_cpu_run(tiny_root):
    result = run.run_cell(tiny_root, WORKLOAD, 2**31 + 21, 1, True, "cpu")
    assert result["correct"]
    assert result["metrics"][NAME]["value"] == 1.0


@pytest.mark.parametrize("jobs, share", [
    ([(3_900_000, 3_900_000), (3_800_000, 3_800_000)], 1.0),
    ([(3_900_000, 0), (3_800_000, 0)], 0.0),
    ([(3_000_000, 3_000_000), (1_000_000, 0)], 0.75),  # summed over the window's jobs
])
def test_the_reader_by_hand(jobs, share):
    stderrs = [_stderr(dict(BASE, **{"dupscan.rows": r, "dupscan.native_rows": n})) for r, n in jobs]
    assert _read(stderrs) == pytest.approx(share)


@pytest.mark.parametrize("stderr", [
    _stderr(BASE),                                  # a program without the counters, or a scan from the cache
    "Align phase: 2000 queries in 1.0s\n",          # a program without the line
    "[trace] {not json\n",                          # a broken line
])
def test_a_program_without_the_counters_gives_nothing(stderr):
    assert _read([stderr]) is None
