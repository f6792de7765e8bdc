"""Where `MatchDatabase.group_by_position` spends a job's pileup time: the
Python passes against the one native pass, by part, on one cell's real
alignments.

    python3 experiments/pileup_split.py --workload se150_gapped --seed N [--repeat 3] [--min-length 50]

Makes the cell's sample from `--seed` (`portbench.run.make_sample`), runs
one CLI job over it and keeps the alignments its MatchDatabase was handed.
`--min-length L` then cuts each of the engine's ungapped results to a
length drawn from [L, its length] at the read's 3' end (as adapter trimming
does), so that the fast groups, keyed by read length, number in the
hundreds; the gapped results keep their length.  Then, `--repeat` times
each, on a fresh MatchDatabase:

- the Python passes (`_accumulate` for every result, `_flush_fast`,
  `_flush_buffers`): `intake_s` (the `_accumulate` loop less the gapped
  blocks), `gapped_s` (`_accumulate_sequence`), `fast_groups_s`
  (`_flush_fast`), `buffers_s` (`_flush_buffers`);
- the native pass (`group_by_position` with the library): `intake_s` (all
  but the call), `native_s` (the call), `total_s`.

Prints one JSON line with each part's median, `add_at_share` (the share of
`_flush_fast`'s time that cProfile puts in `np.add.at`, one profiled run),
and whether both ways left every array equal under `np.array_equal` and the
insertion events equal and in order (`equal`); exits 1 where they differ.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import json
import pstats
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import cells, run  # noqa: E402


def capture(root: Path, workload: str, seed: int, device: str, work: Path):
    """One CLI job over the cell's sample; the alignments its pileup got."""
    cell = cells.load(root, workload)
    run.environment(root, device)
    from mapper_tpu_torch import cli, pileup

    sample = run.make_sample(cell, seed, work)
    (work / "out").mkdir()
    kept = {}
    original = pileup.MatchDatabase.group_by_position

    def keep(self, *args, **kwargs):
        kept.setdefault("pending", list(self._pending))
        kept.setdefault("query_end_fraction", self.query_end_fraction)
        return original(self, *args, **kwargs)

    pileup.MatchDatabase.group_by_position = keep
    try:
        job = run.run_job(cli.main, run.cli_argv(cell.config, sample.files, work / "out", work / "index_cache"))
    finally:
        pileup.MatchDatabase.group_by_position = original
    if job.error is not None or job.rc != 0:
        raise RuntimeError(f"the CLI job failed (rc {job.rc}):\n{job.error or ''}{job.stderr[-3000:]}")
    return kept["pending"], kept["query_end_fraction"]


def python_passes(pending, query_end_fraction):
    from mapper_tpu_torch.pileup import MatchDatabase

    db = MatchDatabase(query_end_fraction)
    gapped = [0.0]
    accumulate_sequence = db._accumulate_sequence

    def timed(*args):
        t = time.perf_counter()
        accumulate_sequence(*args)
        gapped[0] += time.perf_counter() - t

    db._accumulate_sequence = timed
    db._buffers, db._fast = {}, []
    t0 = time.perf_counter()
    for query_alignments in pending:
        db._accumulate(query_alignments)
    t1 = time.perf_counter()
    db._flush_fast()
    t2 = time.perf_counter()
    db._flush_buffers()
    t3 = time.perf_counter()
    parts = {"intake_s": t1 - t0 - gapped[0], "gapped_s": gapped[0], "fast_groups_s": t2 - t1,
             "buffers_s": t3 - t2, "total_s": t3 - t0}
    return db, parts


def native_pass(pending, query_end_fraction):
    from mapper_tpu_torch.native import pileup as native_pileup
    from mapper_tpu_torch.pileup import MatchDatabase

    db = MatchDatabase(query_end_fraction)
    db.add_alignments(pending)
    stamps = {}
    lib = native_pileup.get_library()
    call = lib.mapper_pileup_accumulate

    def timed_call(*args):
        t = time.perf_counter()
        status = call(*args)
        stamps["native"] = time.perf_counter() - t
        return status

    lib.mapper_pileup_accumulate = timed_call
    try:
        t0 = time.perf_counter()
        db.group_by_position()
        t1 = time.perf_counter()
    finally:
        lib.mapper_pileup_accumulate = call
    if "native" not in stamps:
        raise RuntimeError("the native pass did not take the alignments")
    parts = {"intake_s": t1 - t0 - stamps["native"], "native_s": stamps["native"], "total_s": t1 - t0}
    return db, parts


def trimmed(pending, min_length: int, seed: int):
    """The engine's ungapped results cut at the 3' end to lengths drawn
    from [min_length, length]; a reverse row's window starts the cut's
    length later.  The other results as they are."""
    import numpy as np

    from mapper_tpu_torch.align.blocks import LazyUngappedAlignments
    from mapper_tpu_torch.sequence import Sequence

    rng = np.random.default_rng(seed)
    out = []
    for result in pending:
        if not isinstance(result, LazyUngappedAlignments):
            out.append(result)
            continue
        seq = result.query_sequences[0]
        full = len(seq.codes)
        keep = int(rng.integers(min(min_length, full), full + 1))
        cut = Sequence(seq.name, seq.codes[:keep].copy(), identifier=seq.identifier)
        rows = [(rev, ref, off + (full - keep if rev else 0), pen) for rev, ref, off, pen in result.rows]
        out.append(LazyUngappedAlignments([cut], rows, None))
    return out


def add_at_share(pending, query_end_fraction) -> float:
    from mapper_tpu_torch.pileup import MatchDatabase

    db = MatchDatabase(query_end_fraction)
    db._buffers, db._fast = {}, []
    for query_alignments in pending:
        db._accumulate(query_alignments)
    profile = cProfile.Profile()
    profile.enable()
    db._flush_fast()
    profile.disable()
    stats = pstats.Stats(profile).stats
    total = sum(tt for (_, _, name), (_, _, tt, _, _) in stats.items())
    add_at = sum(tt for (_, _, name), (_, _, tt, _, _) in stats.items() if "'at' of 'numpy.ufunc'" in name)
    return add_at / total if total else 0.0


def same(a, b) -> bool:
    import numpy as np

    if list(a) != list(b):  # the contigs, in the same order
        return False
    for p, q in zip(a.values(), b.values()):
        for name in ("middle", "end", "deletion_start_middle"):
            if not np.array_equal(getattr(p, name), getattr(q, name)):
                return False
        if list(p.insertions.items()) != list(q.insertions.items()):
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 experiments/pileup_split.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--min-length", type=int, default=None,
                    help="cut the ungapped results to lengths drawn from [this, their length]")
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout whose BENCHMARK.json is run")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at a shrunk size, which measures nothing")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="pileup-split-") as tmp:
        pending, qef = capture(args.root, args.workload, args.seed, args.device, Path(tmp))
    if args.min_length is not None:
        pending = trimmed(pending, args.min_length, args.seed)
    python_parts, native_parts, equal = [], [], True
    for _ in range(args.repeat):
        python_db, parts = python_passes(pending, qef)
        python_parts.append(parts)
        native_db, parts = native_pass(pending, qef)
        native_parts.append(parts)
        equal = equal and same(python_db.pileups, native_db.pileups)
        del python_db, native_db
        gc.collect()

    def medians(runs):
        return {k: statistics.median(parts[k] for parts in runs) for k in runs[0]}

    lengths = {len(r.query_sequences[0].codes) for r in pending}
    out = {"workload": args.workload, "seed": args.seed, "device": args.device, "min_length": args.min_length,
           "results": len(pending), "read_lengths": [min(lengths), max(lengths)], "distinct_lengths": len(lengths),
           "python": medians(python_parts), "native": medians(native_parts),
           "add_at_share": add_at_share(pending, qef), "equal": equal}
    out["speedup"] = out["python"]["total_s"] / out["native"]["total_s"]
    print(json.dumps(out), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
