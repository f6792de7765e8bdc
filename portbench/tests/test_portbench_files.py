"""BENCHMARK.json keeps to the benchmark's contract, and every cell resolves
to files that exist."""

import json
import re

import pytest

from portbench import cells
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert (REPO / path).is_dir()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"])) and (REPO / c["file"]).is_file()
        assert c["file"] not in files and len(c["reduced"]) <= 16
        files.add(c["file"])
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]


def test_workloads_resolve(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = cells.load(REPO, w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cells.reader(REPO, m["name"]))
        assert set(cell.limits["limits"]) >= {"bad_rows", "missing_reads", "penalty_gap"}
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()


def test_metrics(bench):
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in bench["end_to_end"])
    workloads = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and one_line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= workloads
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", workloads)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
