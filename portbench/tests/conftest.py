"""Fixtures of the benchmark's own tests (run from the repository's root:
`python -m pytest portbench/tests -q -p no:cacheprovider`; on a card,
`python3 -m pytest portbench/tests -q -p no:cacheprovider -m cuda`)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
# the tiny shapes a CPU test run holds; widths (read length, split size,
# penalties, pair geometry, the planted copies' number and SNP rate) stay the
# configurations'.  Reads past a kilobase, which the CPU's plain scorer
# aligns far more slowly a base, are cut to `long_bases` bases in all; a
# planted segment to `segment` bases, so that its copies fit the reference.
TINY = {"length": 200_000, "count": 3000, "pairs": 1500, "warmup_reads": 512, "long_bases": 120_000,
        "long_warmup_reads": 2, "segment": 10_000}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without a card")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")


def copy_bench(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's files, without caches or tests."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    return dest


def shrink(root: Path) -> None:
    """Cuts every configuration under `root` to the CPU test's size."""
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["reference"]["length"] = TINY["length"]
        if "repeats" in cfg["reference"]:
            cfg["reference"]["repeats"]["segment"] = min(cfg["reference"]["repeats"]["segment"], TINY["segment"])
        long = cfg["reads"]["length"] > 1000
        for key in ("count", "pairs"):
            if key in cfg["reads"]:
                cfg["reads"][key] = TINY["long_bases"] // cfg["reads"]["length"] if long else TINY[key]
        cfg["warmup_reads"] = TINY["long_warmup_reads"] if long else TINY["warmup_reads"]
        path.write_text(json.dumps(cfg))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = copy_bench(tmp_path / "checkout")
    shrink(root)
    return root
