"""Where the duplication scan's time goes, on a benchmark cell's reference:
the native pass (`native/dupscan.cpp`) against the vectorized numpy pass it
replaced, each split into its parts, and the two checked equal.

    python3 experiments/dupscan_split.py --workload c5_long10k_split --seed N [--root DIR]

Builds the cell's seeded reference as `portbench.run.make_sample` does and
the index the CLI builds on it; with `--infer-ancestors` in the cell's
flags, also the source index, the three-copy scan over it (the scan the
ancestry detection reads) and the inferred ancestor with its index, as
`cli.run` does.  Then, for each scan the CLI runs (three copies over the
source index, two over the index it aligns to), times in turns the native
pass and the vectorized one: the hashing of the scan's block lengths (once,
before both), the grouping (the native call, or the vectorized pass less
`_insert`) and `_insert`; and checks the `pending` lists and `_by_sequence`
equal.  Prints one JSON line; `--root` takes a shrunk copy of the benchmark
(`portbench/tests/conftest.py`'s `shrink`) to rehearse it on a small
machine.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mapper_tpu_torch.index import duplication  # noqa: E402
from mapper_tpu_torch.index.ancestry import AncestryDetector  # noqa: E402
from mapper_tpu_torch.index.database import (  # noqa: E402
    HashBlockDatabase,
    choose_max_duplication_length,
    choose_min_duplication_length,
)
from mapper_tpu_torch.native import dupscan as native_dupscan  # noqa: E402
from mapper_tpu_torch.sequence import Sequence, SequenceDatabase, sort_and_complement  # noqa: E402
from portbench import cells, generate  # noqa: E402


def reference(cell, seed: int) -> str:
    cfg = cell.config
    rng = np.random.default_rng(seed)
    repeats = cfg["reference"].get("repeats")
    if repeats:
        text, _ = generate.planted_reference(rng, cfg["reference"]["length"], repeats["segment"],
                                             repeats["copies"], repeats["snp_rate"])
        return text
    return generate.random_reference(rng, cfg["reference"]["length"])


def scan(database, lo: int, hi: int, copies: int, window: int, native: bool) -> dict:
    """One full scan; its parts' seconds, the rows' count and what it
    handed to `_insert`."""
    detector = duplication.DuplicationDetector(database, lo, hi, min_num_interesting_copies=copies,
                                               window_size=window)
    seconds = {"group": 0.0, "insert": 0.0}
    pending = []
    insert, group = detector._insert, native_dupscan.group

    def timed_insert(items):
        pending.extend((pos, dup.length, tuple(dup.positions)) for pos, dup in items)
        t = time.perf_counter()
        insert(items)
        seconds["insert"] += time.perf_counter() - t

    def timed_group(*args):
        t = time.perf_counter()
        out = group(*args)
        seconds["group"] += time.perf_counter() - t
        return out

    detector._insert = timed_insert
    native_dupscan.group = timed_group if native else (lambda *args: None)
    try:
        t = time.perf_counter()
        detector.ensure_detected()
        total = time.perf_counter() - t
    finally:
        native_dupscan.group = group
    if not native:
        seconds["group"] = total - seconds["insert"]
    by_sequence = {k: [(s, d.length, tuple(d.positions)) for s, d in v] for k, v in detector._by_sequence.items()}
    return {"s": total, **{f"{k}_s": v for k, v in seconds.items()}, "entries": sum(map(len, by_sequence.values())),
            "pending": len(pending), "_pending": pending, "_by_sequence": by_sequence}


def compare(name: str, database, lo: int, hi: int, copies: int, window: int) -> dict:
    t = time.perf_counter()
    database.require_set_up_through_size(hi)
    out = {"scan": name, "lengths": [lo, hi], "copies": copies, "window": window,
           "hash_s": time.perf_counter() - t}
    runs = {"native": [], "numpy": []}
    for native in (True, False, True, False):
        runs["native" if native else "numpy"].append(scan(database, lo, hi, copies, window, native))
    first = runs["native"][0]
    out["equal"] = all(r["_pending"] == first["_pending"] and r["_by_sequence"] == first["_by_sequence"]
                       for side in runs.values() for r in side)
    for side, found in runs.items():
        out[side] = [{k: v for k, v in r.items() if not k.startswith("_")} for r in found]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    cell = cells.load(Path(args.root), args.workload)
    cfg = cell.config
    t = time.perf_counter()
    text = reference(cell, args.seed)
    sorted_reference = sort_and_complement([Sequence.from_text(cfg["reference"]["name"], text)])
    seq_db = SequenceDatabase(sorted_reference)
    lo, hi = choose_min_duplication_length(seq_db), choose_max_duplication_length(seq_db)
    result = {"workload": args.workload, "seed": args.seed, "bases": len(text), "reference_s": time.perf_counter() - t,
              "library": native_dupscan.get_library() is not None, "scans": []}
    if "--infer-ancestors" in cfg["cli"]:
        t = time.perf_counter()
        source = HashBlockDatabase(seq_db, min_interesting_size=lo, hint_max_interesting_size=hi,
                                   max_num_short_matches=8, enable_gapmers=True)
        result["source_index_s"] = time.perf_counter() - t
        result["scans"].append(compare("source, three copies", source, lo, hi, 3, 1))
        detector = duplication.DuplicationDetector(source, lo, hi, min_num_interesting_copies=3, window_size=1)
        dissimilarity = cfg["max_error_rate"] / cfg["penalties"]["mutation"]
        t = time.perf_counter()
        database = AncestryDetector(detector, sorted_reference, dissimilarity).get_hashblock_database()
        result["ancestor_s"] = time.perf_counter() - t
        name = "ancestor, two copies"
    else:
        t = time.perf_counter()
        database = HashBlockDatabase(seq_db, hint_max_interesting_size=hi, enable_gapmers=True)
        result["index_s"] = time.perf_counter() - t
        name = "reference, two copies"
    result["scans"].append(compare(name, database, lo, hi, 2, 1000))
    print(json.dumps(result))
    return 0 if all(s["equal"] for s in result["scans"]) else 1


if __name__ == "__main__":
    sys.exit(main())
