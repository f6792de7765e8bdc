"""Finds a cell's files by the names in `BENCHMARK.json`: its
configuration (the entry's `file`), its traffic mix
(`portbench/traffic/<traffic>.json`), its limits
(`portbench/cells/<workload>.json`) and its per-layer metric readers
(`portbench/metrics/<metric>.py`).  A new cell, mix or metric is a new
file and a new entry; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]  # the per-layer metrics this cell reports


def load(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}; have {sorted(cells)}")
    entry = cells[workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "cells" / f"{workload}.json").read_text())
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload]) and m["moves"] in reported]
    return Cell(workload, int(entry["chips"]), config, traffic, limits, end_to_end, per_layer)


def reader(root: Path, metric: str):
    """The `read(ctx)` function of `portbench/metrics/<metric>.py`."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
