"""The cell `c5_long10k_split` (BASELINE config 5) and its three per-layer
metrics of the host ancestry inference: `ancestry.infer_s`,
`ancestry.index_s` and `ancestry.job_share`, computed by hand on hand-made
`[trace]` lines and silent (None) where the program opens no `ancestry.*`
span; the committed cell resolves, and a shrunk traced CPU run of it is
correct and reads all three."""

import json
from types import SimpleNamespace

import pytest

from portbench import cells, run
from portbench.tests.conftest import REPO

WORKLOAD = "c5_long10k_split"
METRICS = ("ancestry.infer_s", "ancestry.index_s", "ancestry.job_share")


def _read(name, stderrs):
    ctx = SimpleNamespace(jobs=[SimpleNamespace(stderr=s, stdout="") for s in stderrs], reads_per_job=2000,
                          spans=SimpleNamespace(spans=[("job", 10.0, 40.0)]), device=None, config={})
    return cells.reader(REPO, name)(ctx)


def _stderr(spans, counts=None):
    record = {"clock": "perf_counter", "spans": spans, "counts": counts or {}}
    return "Loading reference\n[trace] " + json.dumps(record) + "\nDone\n"


def _job(t, scale=1.0):
    """One job from `t` to `t + 30`: the ancestry spans inside `cli.index`
    (1 + 2 + 3 + 0.5 + 2.5 s, times `scale`), the duplication scan on its
    thread and the main thread's 6 s wait for it."""
    s = scale
    return [
        ["cli.main", "MainThread", t, t + 30.0, 20.0, None, None],                           # 0
        ["cli.reference", "MainThread", t, t + 1.0, 1.0, 0, None],                           # 1
        ["cli.index", "MainThread", t + 1.0, t + 1.0 + 9.0 * s, 9.0, 0, None],               # 2
        ["ancestry.source_index", "MainThread", t + 1.0, t + 1.0 + s, 1.0, 2, None],          # 3
        ["ancestry.detect", "MainThread", t + 1.0 + s, t + 1.0 + 3 * s, 2.0, 2, None],       # 4
        ["ancestry.walk", "MainThread", t + 1.0 + 3 * s, t + 1.0 + 6 * s, 3.0, 2, None],     # 5
        ["ancestry.emit", "MainThread", t + 1.0 + 6 * s, t + 1.0 + 6.5 * s, 0.5, 2, None],   # 6
        ["ancestry.index", "MainThread", t + 1.0 + 6.5 * s, t + 1.0 + 9 * s, 2.5, 2, None],  # 7
        ["cli.dup_scan", "duplication-scan", t + 12.0, t + 24.0, 12.0, None, None],          # 8
        ["cli.dup_wait", "MainThread", t + 18.0, t + 24.0, 0.0, 0, None],                    # 9
        ["cli.align", "MainThread", t + 24.0, t + 29.0, 3.0, 0, None],                       # 10
    ]


COUNTS = {"split.reads": 2000, "split.pieces": 14000, "ancestry.duplications": 120, "ancestry.bases_widened": 2100}


@pytest.mark.parametrize("name, want", [
    ("ancestry.infer_s", (5.5 + 11.0) / 2),      # detect + walk + emit, the mean over two jobs
    ("ancestry.index_s", (3.5 + 7.0) / 2),       # both indexes
    ("ancestry.job_share", ((9.0 + 6.0) / 30.0 + (18.0 + 6.0) / 30.0) / 2),  # with cli.dup_wait, over cli.main
])
def test_the_readers_by_hand(name, want):
    assert _read(name, [_stderr(_job(10.0), COUNTS), _stderr(_job(50.0, scale=2.0), COUNTS)]) == pytest.approx(want)


def _without_ancestry():
    return [s for s in _job(10.0) if not s[0].startswith("ancestry.")]


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("stderr", [
    _stderr(_without_ancestry()),                   # a program without the spans, or a run without ancestry
    "Align phase: 2000 queries in 1.0s\n",          # a program without the line
    "[trace] {not json\n",                          # a broken line
])
def test_a_program_without_the_spans_gives_nothing(name, stderr):
    assert _read(name, [stderr]) is None


def test_the_committed_cell_resolves():
    cell = cells.load(REPO, WORKLOAD)
    assert cell.chips == 1 and cell.config["name"] == "c5_long10k" and cell.traffic["name"] == "snp2_any_strand"
    assert cell.config["reads"] == {"layout": "single", "count": 2000, "length": 10_000, "split_past": 1500}
    assert cell.config["reference"]["length"] == 10_000_000
    assert [m["name"] for m in cell.end_to_end] == ["reads_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert {"ancestor_faults", "ancestor_columns_missing"} <= set(cell.limits["limits"])


def test_a_shrunk_traced_cpu_run_is_correct_and_reads_every_metric(tiny_root):
    result = run.run_cell(tiny_root, WORKLOAD, 2**31 + 2020, 1, True, "cpu")
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert list(result["checks"])[-2:] == ["ancestor_faults", "ancestor_columns_missing"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == set(METRICS)
    assert metrics["ancestry.infer_s"] > 0 and metrics["ancestry.index_s"] > 0
    assert 0 < metrics["ancestry.job_share"] < 1
