"""The per-layer metrics that read the program's own `[trace]` line
(`program_trace.py`): read on a traced CPU run of each cell, computed by
hand on a hand-made line and device trace, and silent (None) where the
program writes no such line."""

import json
from types import SimpleNamespace

import pytest

from portbench import cells, program_trace, run
from portbench.tests.conftest import REPO

NEW = ("cli.load_s", "cli.dupscan_wait_s", "cli.parse_ms_per_kread", "cli.listeners_ms_per_kread",
       "cli.outputs_s", "engine.certificate_ms_per_kread", "engine.decide_ms_per_kread", "engine.fallback_share",
       "device.idle_unattributed_share")


def _reader(name):
    return cells.reader(REPO, name)


@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_every_new_metric_reads_a_traced_cpu_run(tiny_root, workload):
    result = run.run_cell(tiny_root, workload, 2**31 + 9, 1, True, "cpu")
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    # the CPU run has no device trace: the one device metric stays silent
    assert set(NEW) - set(metrics) == {"device.idle_unattributed_share"}
    for name in NEW[:-1]:
        assert metrics[name] >= 0, name
    assert metrics["cli.load_s"] > 0 and metrics["engine.decide_ms_per_kread"] > 0
    assert 0 <= metrics["engine.fallback_share"] <= 1
    if workload == "se150_gapped":
        # the legacy stdout line times the same interval as engine.decide
        assert metrics["engine.decide_ms_per_kread"] == pytest.approx(
            metrics["engine.decisions_ms_per_kread"], rel=0.05)


def _job(record):
    return SimpleNamespace(stderr="Loading reference\n[trace] " + json.dumps(record) + "\nDone\n", stdout="")


def _ctx(records, job_spans, device, reads=2000):
    return SimpleNamespace(jobs=[_job(r) for r in records], reads_per_job=reads,
                           spans=SimpleNamespace(spans=job_spans), device=device, config={})


# one job from 10.0 to 20.0 s: main-thread leaves, a pool thread's batch
# container with two leaves, and a duplication scan on its own thread
RECORD = {
    "clock": "perf_counter",
    "spans": [
        ["cli.main", "MainThread", 10.0, 20.0, 9.0, None, None],            # 0
        ["cli.reference", "MainThread", 10.0, 11.0, 1.0, 0, None],          # 1
        ["cli.index", "MainThread", 11.0, 12.0, 1.0, 0, None],              # 2
        ["cli.dup_wait", "MainThread", 12.5, 13.0, 0.0, 0, None],           # 3
        ["cli.align", "MainThread", 13.0, 18.0, 2.0, 0, None],              # 4
        ["cli.parse", "MainThread", 13.0, 13.5, 0.5, 4, 0],                 # 5
        ["cli.wait", "MainThread", 13.5, 17.0, 0.1, 4, 0],                  # 6
        ["cli.listeners", "MainThread", 17.0, 18.0, 1.0, 4, 0],             # 7
        ["engine.batch", "batch_0", 13.5, 17.0, 3.0, None, 0],              # 8
        ["engine.certificate", "batch_0", 13.6, 14.0, 0.4, 8, 0],           # 9
        ["engine.decide", "batch_0", 15.0, 16.0, 1.0, 8, 0],                # 10
        ["cli.dup_scan", "duplication-scan", 12.0, 13.0, 1.0, None, None],  # 11
        ["cli.write", "MainThread", 18.5, 19.0, 0.5, 0, None],              # 12
        ["cli.report", "MainThread", 19.0, 19.5, 0.5, 0, None],             # 13
    ],
    "counts": {"reads.single": 2000, "reads.fallback": 50, "rows.candidates": 9000, "rows.device": 2000},
}
# the device busy from 14.5 to 15.5 and in the gap 18.0-18.5; the window 9-21
DEVICE = {"start": 9.0, "end": 21.0, "busy": [[14.5, 15.5], [18.1, 18.2]], "by_name": {}, "ops": []}
JOBS = [("job", 10.0, 20.0), ("banded_i16", 14.5, 15.5)]


def test_idle_unattributed_share_by_hand():
    # idle inside the job: 10 s less 1.1 s busy = 8.9 s.  Leaves open on
    # some thread: 10-12 (reference, index), 12-13 (dup scan), 12.5-13,
    # 13-13.5 (parse), 13.5-17 (wait), 17-18 (listeners), 18.5-19.5; not
    # covered: 18.0-18.5 less 0.1 busy, and 19.5-20.0 = 0.9 s
    share = program_trace.idle_unattributed_share(DEVICE, JOBS, [RECORD])
    assert share == pytest.approx(0.9 / 8.9)
    assert _reader("device.idle_unattributed_share")(_ctx([RECORD], JOBS, DEVICE)) == pytest.approx(0.9 / 8.9)
    # without the main thread's wait span, 13.5-17 is covered by the pool's
    # leaves alone (13.6-14, 15-16), less the busy 14.5-15.5
    no_wait = dict(RECORD, spans=[s if s[0] != "cli.wait" else ["cli.wait", "MainThread", 13.5, 13.5, 0, 4, 0]
                                  for s in RECORD["spans"]])
    uncovered = 0.9 + 0.1 + 0.5 + 1.0  # and 13.5-13.6, 14.0-14.5 (busy from 14.5), 16-17
    assert program_trace.idle_unattributed_share(DEVICE, JOBS, [no_wait]) == pytest.approx(uncovered / 8.9)
    by_leaf = program_trace.idle_by_leaf(DEVICE, JOBS, [RECORD])
    assert sum(by_leaf.values()) == pytest.approx(8.9)
    assert by_leaf["none"] == pytest.approx(0.9)
    # 13.6-14.0 is the certificate's, not the main thread's wait
    assert by_leaf["engine.certificate"] == pytest.approx(0.4)


def test_the_readers_by_hand():
    ctx = _ctx([RECORD, RECORD], JOBS, DEVICE)
    read = {name: _reader(name)(ctx) for name in NEW}
    assert read["cli.load_s"] == pytest.approx(2.0)
    assert read["cli.dupscan_wait_s"] == pytest.approx(0.5)
    assert read["cli.outputs_s"] == pytest.approx(1.0)
    assert read["cli.parse_ms_per_kread"] == pytest.approx(2 * 500 / 4)
    assert read["cli.listeners_ms_per_kread"] == pytest.approx(2 * 1000 / 4)
    assert read["engine.certificate_ms_per_kread"] == pytest.approx(2 * 400 / 4)
    assert read["engine.decide_ms_per_kread"] == pytest.approx(2 * 1000 / 4)
    assert read["engine.fallback_share"] == pytest.approx(50 / 2000)


def test_a_program_without_the_line_gives_nothing():
    """The parent of the change that added the line: every new reader
    returns None and raises nothing."""
    ctx = SimpleNamespace(jobs=[SimpleNamespace(stderr="Align phase: 2000 queries in 1.0s\n", stdout="")],
                          reads_per_job=2000, spans=SimpleNamespace(spans=JOBS), device=DEVICE, config={})
    assert all(_reader(name)(ctx) is None for name in NEW)
    broken = SimpleNamespace(jobs=[SimpleNamespace(stderr="[trace] {not json\n", stdout="")], reads_per_job=2000,
                             spans=SimpleNamespace(spans=JOBS), device=DEVICE, config={})
    assert all(_reader(name)(broken) is None for name in NEW)
