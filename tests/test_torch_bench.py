"""The port's bench (`mapper_tpu_torch.bench`) against the root `bench.py`:
the same simulated reads for the same seed, the JSON line's keys, and a
source that reaches neither JAX nor the JAX package nor the root bench's
service-phase probes.  The module constants are cut to 256 reads against a
50 kb reference in both modules."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench as root_bench
from mapper_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
SMALL = {"NUM_READS": 256, "REFERENCE_SIZE": 50_000}
DETAIL_KEYS = {
    "package", "device", "num_reads", "aligned_fraction", "fallback_reads", "index_build_seconds",
    "align_seconds", "methodology", "median_reads_per_second", "pass_seconds", "e2e_dp_gcells_per_s",
}


@pytest.fixture
def small(monkeypatch):
    for module in (bench, root_bench):
        for name, value in SMALL.items():
            monkeypatch.setattr(module, name, value)
    monkeypatch.setattr(bench, "NUM_GROUPS", 2)
    monkeypatch.setattr(bench, "PASSES_PER_GROUP", 1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 1])
def test_simulate_gives_the_root_bench_reads(small, seed):
    ref, reads = bench.simulate(seed)
    root_ref, root_reads = root_bench.simulate(seed)
    assert ref == root_ref and len(ref) == SMALL["REFERENCE_SIZE"]
    assert [r.name for r in reads] == [r.name for r in root_reads]
    assert [r.get_text() for r in reads] == [r.get_text() for r in root_reads]
    assert len(reads) == SMALL["NUM_READS"]


def test_constants_are_the_root_bench_workload():
    for name in ("NUM_READS", "READ_LENGTH", "REFERENCE_SIZE", "SNP_RATE", "BASELINE_JAVA_READS_PER_SECOND",
                 "NUM_GROUPS", "PASSES_PER_GROUP"):
        assert getattr(bench, name) == getattr(root_bench, name), name


def test_main_prints_one_json_line(small, monkeypatch, capsys):
    monkeypatch.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
    assert bench.main() == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["metric"] == "reads_per_second_per_chip" and line["unit"] == "reads/s"
    detail = line["detail"]
    assert set(detail) == DETAIL_KEYS
    assert detail["package"] == "mapper_tpu_torch" and detail["device"] == "cpu"
    assert detail["methodology"] == "min_of_passes"
    assert detail["num_reads"] == SMALL["NUM_READS"] and detail["aligned_fraction"] >= 0.99
    assert len(detail["pass_seconds"]) == 2 and detail["align_seconds"] == min(detail["pass_seconds"])
    assert line["value"] == pytest.approx(SMALL["NUM_READS"] / detail["align_seconds"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / bench.BASELINE_JAVA_READS_PER_SECOND)
    launches = [l for l in captured.err.splitlines() if l.startswith("[bench] kernel launches in the timed passes: ")]
    assert len(launches) == 1
    assert not any(json.loads(launches[0].split(": ", 1)[1]).values())  # the CPU launches no kernel


def test_source_reaches_no_jax_and_no_probe():
    """No import of JAX, the JAX package or the root scripts; none of the
    root bench's probes, their nominals, its degraded-phase flag or its
    sleep between groups (the module's docstring names them)."""
    tree = ast.parse(Path(bench.__file__).read_text())
    docstring = tree.body[0].value
    words = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            words.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            words.add((node.module or "").split(".")[0])
        elif isinstance(node, ast.Name):
            words.add(node.id)
        elif isinstance(node, ast.Attribute):
            words.add(node.attr)
        elif isinstance(node, ast.FunctionDef):
            words.add(node.name)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and node is not docstring:
            words.update(node.value.replace('"', " ").split())
    assert "torch" in words and "simulate" in words
    banned = {"jax", "jaxlib", "mapper_tpu", "bench", "__graft_entry__", "_host_probe", "_make_device_probe",
              "BENCH_GAP", "GROUP_GAP_SECONDS", "phase_degraded", "probe_nominals", "sleep"}
    assert not words & banned, words & banned


def test_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "MAPPER_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "mapper_tpu_torch.bench"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
