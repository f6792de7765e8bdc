"""Smoke run of mapper_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
1. print the card's name and power limit, build the CUDA kernels from
   `mapper_tpu_torch/align/csrc/` (`banded_dp.cu`, `probe_i16.cu` and
   `candidates.cu`, one nvcc each, started together) and print the build
   time;
2. compare each kernel with its plain PyTorch version on the card at the
   main paths' shapes and time both with CUDA events, every scorer exactly
   equal (torch.equal) to its plain version: banded_i16 at read width 192,
   bands 64 and 128, 16,384 candidates; banded_f32 at width 1024, bands 64
   and 128 (both instantiations of its warp kernel), 4,096 candidates;
   banded_i16_packed on the host-window rows of width 192 (256 padded) at
   band 64, timed in turns against banded_i16 on the same rows (the pair
   behind `banded_scores`' band-64 route); banded_roll_f32 and
   banded_chunk_f32 (chunk 128) on the rows of width 1024 at bands 64 and
   128, timed in turns with each other (A B B A), and banded_roll_f32's
   block kernel once at band 32;
   the probe kernels P1-P9: all 40 bodies on the probes' own [64, 128]
   input, on a seeded one over the whole int16 range and at [16384, 128]
   (one row per candidate of the 150 bp phase), each exactly equal to its
   plain version, and timed at [16384, 128] by CUDA-graph replay, in turns
   with its one PyTorch call where one computes the same function
   (`PROBE_LIBRARY`, held equal to the plain version first).
   Each kernel's bound is computed from this run's inputs: the larger of
   the operations its DP cells need (`DP_RATES`: operations a cell, min(n,
   LQ) x band cells, over the card's rate for their type) and its bytes
   (each input read once, each output written once) over the memory rate;
3. the probe path: `python -m mapper_tpu_torch.probe_i16 <stage>` for each
   of the nine stages, in this process with the launch counts read around
   it (every stage's kernel must launch, every body print "OK exact"),
   then as nine subprocesses started together, each of which must exit 0;
4. the host-window path: `banded_scores` on rows gathered on the card
   (`banded._gather_codes`) from candidates over a 4.6 Mb reference, with
   the launch counts read around it: "pen" at width 192 (band 64 through
   banded_i16_packed, band 128 through banded_i16) and 1024 (bands 64 and
   128, f32), "roll" and "chunk" at width 1024, band 128.  All five kernels
   must launch; "pen" scores and diagonal sums at each lane must equal
   `banded_scores_gathered` on the same candidates exactly, the packed
   band-64 run must equal banded_i16 on the same rows exactly, and "roll",
   "chunk" and "pen" f32 scores must equal the plain version's bit for bit;
5. run the CLI (`mapper_tpu_torch.cli.main`) on a simulated 4.6 Mb
   reference, the size of E. coli K-12: 100,000 single-end 150 bp reads
   (1% SNPs, a 1-3 bp indel in 10% of reads, half reverse-complemented) and
   2,000 reads of 1,000 bp in a second run, each with --out-sam --out-vcf
   --out-mutations --out-refs-map-count --out-unaligned.  The first is the
   main path (the default CLI run), its launch counts read around it alone;
   banded_i16 must launch there and banded_f32 in the second; at least 99%
   of reads must align, and SAM, VCF and mutations must
   be byte-identical to the same runs on the CPU (MAPPER_TPU_TORCH_DEVICE=
   cpu: the kernels' plain versions, the port's reference for every
   kernel), which must launch no kernel;
6. the device pileup: the 100,000-read run again with
   MAPPER_TPU_DEVICE_PILEUP=1, launch counts read around it.  banded_i16
   must launch, rows must have been counted on the card, and SAM, VCF and
   mutations must be byte-identical to the run without it;
7. the device-candidates path (`batch/device_candidates.py`): KC1
   (`candidates_kernel`) and KC2 (`fused_rows_kernel`, `candidates.cu`)
   against their plain versions on the card (torch.equal, the same dtypes)
   on four chunks: the first 4,096 reads of the 150 bp run, the 2,000 reads
   of 1,000 bp, the mates of 2,048 pairs of the paired run, and one 5,000 bp
   read (its row in KC1's scratch buffer), each kernel timed by CUDA-graph
   replay, with CUDA events and on the host clock, beside its plain version
   (CUDA events, host clock), with its bound (this run's
   bytes and operations, `dc_bounds`); on the 150 bp chunk the candidates
   program must give the host candidate pass's rows on every read it does
   not flag, and the fused program's whole int32 output on the card must
   equal the same program on the CPU and through the plain versions on the
   card; the fused program's device operations a call (torch.profiler),
   beside the plain versions', and its host time beside a busy Python
   thread.  Then the 100,000-read CLI run on the fused path
   (MAPPER_TPU_DEVICE_CANDIDATES=1) and kernel-scored in turns (fused,
   kernel, kernel, fused, after phase 5's runs) and the 2,000-read run
   fused, launch counts read around each fused run: every single-end chunk
   must take the fused path, KC1 and KC2 launch once a fused chunk, K1
   launches in the first and K2 in the second, and SAM, VCF and mutations
   must be byte-identical to the CPU-scored twins;
8. a paired run in config 3's shape (20,000 pairs of 2 x 150 bp from
   `benchmarks.simlib.simulate_paired`, --spacing 100 50) and a
   --split-queries-past-size 1500 run (500 reads of 3,000 bp, scored in
   1,500 bp pieces by banded_f32), launch counts read around each, each
   byte-identical to its CPU-scored twin, and the split run again on the
   fused path (every chunk fused, KC1 and KC2 once a fused chunk),
   byte-identical too.  Pairs take the paired path on the fused setting as
   well, as in the JAX engine: phase 7's paired_mates chunk holds KC1 and
   KC2 at their shape.  Then BASELINE configs 4 and 5, built as
   `benchmarks/bench_config4_metagenomic.py` and `bench_config5_longreads.py`
   build them (`simulate_config4`, `simulate_config5`), each with its launch
   counts read around it and every output it writes byte-identical to its
   CPU-scored twin: config 4, 4 genomes of 1 Mb, pairs drawn
   abundance-skewed 2^-g, `--paired-queries --spacing 100 50
   --out-refs-map-count --out-sam` (and `--out-unaligned`), cut from the
   config's 1,000,000 pairs to 20,000 for the smoke's time, banded_i16 must
   launch; config 5, the 10 Mb reference with three mutated 50 kb repeats,
   10 kb reads at 2% SNPs, `--split-queries-past-size 1500 --queries ...
   --infer-ancestors --out-sam` (and `--out-unaligned`), cut from 2,000
   reads to 200, banded_f32 must launch on the 1,500 bp pieces;
9. the parallel slice, on a mesh of two shards of the one card
   (`parallel/mesh.py`; each shard on a CUDA stream of its own), launch
   counts read around each path: `sharded_banded_scores` on the host-window
   rows right after phase 4 (K3, K1 and K2 once a shard, equal to
   `banded_scores`); the engine on the mesh against the one-device engine,
   batch by batch as the CLI batches, on the 100,000 reads of 150 bp
   (banded_i16 twice per chunk that reaches the scorer) with a DevicePileup
   on each (merged arrays equal) and on the 2,000 reads of 1,000 bp
   (banded_f32), every read's summary equal; `ShardedIndex` over the 4.6 Mb
   reference against the host merged-index walk for the seeds of the first
   4,096 reads; the CLI as two processes on the card (`--num-processes 2`,
   started together, with the file barrier and with a gloo
   `--coordinator`), all five outputs byte-identical to the one-process run
   of phase 5; and `--devices 2`, the usage error with one card;
10. the entry points: `graft_entry.entry()`'s step on the card, launch
   counts read around one call (banded_i16's block kernel once, band 32,
   nothing else), its scores equal to `banded_scores_reference` on the same
   arguments (torch.equal) and to the int16 plain version on the card, timed
   by CUDA events; `graft_entry.dryrun_multichip(1)`, its five checks on the
   card, launch counts read around it; and `python -m mapper_tpu_torch.bench`
   as two subprocesses, one after the other, with the engine's default
   settings.  Each run's JSON line is printed; each aligns at least 99% of
   its reads; their launches (the bench's count around its timed passes)
   are recorded under the path `bench`.

The entry points' numbers are printed as one JSON line
(`{"entry_points": ...}`).  The line before the last but one lists the
kernels as JSON, each with its
time, plain time, bound, what bounds it, library time (or null) and its
launches on its own path and on the main path; the line before the last is
the card's name and power limit; the last line is {"ok": true, "device":
{...}}.  Exits non-zero without a card, and without the rest of the
repository beside this file.
"""

from __future__ import annotations

import contextlib
import difflib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the port runs without JAX and without the JAX package: any import of
# either fails from here on
sys.modules["jax"] = None
sys.modules["mapper_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parent))

KERNEL_SOURCE = "mapper_tpu_torch/align/csrc/banded_dp.cu"
PROBE_SOURCE = "mapper_tpu_torch/align/csrc/probe_i16.cu"
DC_SOURCE = "mapper_tpu_torch/align/csrc/candidates.cu"
# the XLA programs KC1 and KC2 replace (no pallas_call)
DC_REPLACES = {
    "candidates": "mapper_tpu/batch/device_candidates.py:406",
    "fused_rows": "mapper_tpu/batch/device_candidates.py:748",
}
REPLACES = {
    "banded_i16": "mapper_tpu/align/pallas_dp.py:511",
    "banded_f32": "mapper_tpu/align/pallas_dp.py:437",
    "banded_i16_packed": "mapper_tpu/align/pallas_dp.py:675",
    "banded_roll_f32": "mapper_tpu/align/pallas_dp.py:357",
    "banded_chunk_f32": "mapper_tpu/align/pallas_dp.py:312",
}
_KEYS = ("reads", "concat", "read_id", "reversed_", "win_start", "lane", "n", "m")
CHUNK = 128
# (read width, band) -> (candidates, seed) of the host-window path
HOST_WINDOW_SHAPES = {
    (192, 64): (16384, 64), (192, 128): (16384, 128), (1024, 64): (4096, 7), (1024, 128): (4096, 7),
}
DC_READS = 4096  # the device-candidates program checks' chunk: the engine's default
PROBE_ROWS = 16384  # the probes' timing block: one row per candidate of the 150 bp phase
PROBE_TURN_CALLS = 50  # calls a replay, when a probe body is timed in turns with its library call

# The card's peaks for the bounds (NVIDIA H100 SXM at its 700 W limit):
# memory 3.35 TB/s; 132 SMs at a 1.98 GHz boost clock, each with 64 int32 and
# 128 float32 lanes, so 16.7 T int32 and 33.5 T float32 operations a second
# (the 67 TFLOP/s float32 figure counts a fused multiply-add as two; the
# DP's adds and mins are one operation each).  An int32 lane takes two int16
# in one s16x2 instruction (SIMD `__vmins2`, DPX `__viaddmin_s16x2`), so the
# int16 DP's rate is twice the int32 one: 33.5 T int16 operations a second.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
I16_OPS_PER_S = 2 * INT32_OPS_PER_S
F32_OPS_PER_S = 132 * 128 * 1.98e9
# operations a float32 DP cell needs: the penalty lookup, the diagonal add
# and clamp, the insertion open and extend with their min and clamp, the min
# of the diagonal and the insertion, the deletion open and extend (a
# sequential scan along the band), their min, the validity select and the
# diagonal sum's add
F32_OPS_PER_CELL = 12
# the same cell in int16 with DPX, where one instruction takes min(a + b, c):
# the penalty lookup 1; the diagonal add and clamp 1; the insertion extend
# and clamp, then its open and their min, 2; the min of the diagonal and the
# insertion 1; the deletion open and clamp, then its extend and the min with
# the chain, 2; the final min 1; the validity select 1; the diagonal sum's
# add 1.  The lookup and the int32 sum are not int16 pairs; counting them at
# the int16 rate as well only lowers the bound.
I16_OPS_PER_CELL = 10
# (operations a cell, operations a second) of each DP type.  A bound is the
# work's, not the code's: banded_i16_packed computes the same int16 DP as
# banded_i16, so it takes the same bound, although it holds its state in
# int32 registers.
DP_RATES = {"i16": (I16_OPS_PER_CELL, I16_OPS_PER_S), "f32": (F32_OPS_PER_CELL, F32_OPS_PER_S)}
# The device-candidates kernels' integer operations: the work the function
# needs, counted from the plain program's operations on this run's data
# (`dc_work`), not from the kernels' code, at the int32 rate.  KC1: a valid
# base (its 2-bit code and flags; each of the two gapmer prefix sums' value,
# its product with a power read from a table, and one add); a block entering
# a level (the next valid neighbour, the merge test, two mergeHashes of nine
# operations, the flag algebra, `extra`); a block after the merge (the
# gapmer's extension and bounds, its two hashes from the prefix tables, each
# with one power read from a table, the key and the size filter); a kept seed
# (its bin's floor modulo and count test); a vote entry (its position, the
# fold and the key), with two operations a step of the sequence search; a
# compare of a sort of the entries (n log2 n of them, two operations for a
# 64-bit key); an entry's vote (the run's neighbour compare and count, and
# one pass for the top K).
KC1_OPS = {"base": 8, "merge": 50, "gapmer": 40, "seed": 10, "entry": 20, "search_step": 2, "compare": 2,
           "vote": 5}
# KC2: a table entry (the keep rule, its block rank) and a kept row (the
# decode's floor divisions, the geometry, six stores).
KC2_OPS = {"entry": 20, "row": 40}
SECTOR_BYTES = 32  # one index gather: a sector of device memory
DC_TIMING_CALLS = 10


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: `reps` calls captured in one CUDA
    graph after one warm-up, then one replay timed with CUDA events.  The host
    issues one replay, so its pace of issuing calls (ctypes and PyTorch's
    dispatcher, 10-20 us a call) is not in the time, as it is in `cuda_ms`."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(cells: float, dp_type: str, moved_bytes: float) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of the operations the DP cells
    need over the card's rate for their type (`DP_RATES`) and the bytes moved
    (each input read once, each output written once) over its memory rate."""
    ops_per_cell, ops_per_s = DP_RATES[dp_type]
    ops_ms = cells * ops_per_cell / ops_per_s * 1e3
    bytes_ms = moved_bytes / MEM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cells_of(n, lq: int, band: int) -> float:
    """DP cells the candidates need: min(n, lq) query positions times the band."""
    import torch

    return float(torch.clamp(torch.as_tensor(n).to(torch.int64), max=lq).sum()) * band


def compare_kernel(name, lq, band, num_cands, params, seed, device):
    """Kernel vs plain version on the card, which must be equal bit for
    bit: (max |difference|, kernel ms, plain ms, bound ms, what bounds it);
    prints the kernel's Gcells/s beside them."""
    import numpy as np
    import torch

    from mapper_tpu_torch.align import banded
    from mapper_tpu_torch.simulate import scoring_candidates

    cands = scoring_candidates(np.random.default_rng(seed), num_cands, lq, band, ref_size=4_600_000, num_reads=4096)
    args = banded._normalize(*[torch.as_tensor(cands[k]).to(device) for k in _KEYS])
    quantized = banded._quantize_params(params, lq, band) is not None
    if quantized != (name == "banded_i16"):
        raise AssertionError(f"{name}: quantizer chose the other kernel at width {lq}")

    def kernel():
        return banded.banded_scores_gathered(*args, params, band)

    def plain():
        return banded._gathered_core(*args, params, band)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name} band {band}: kernel != plain (max error {err})")
    finite = float((got[0] < 1e8).float().mean())
    if finite < 0.5:
        raise AssertionError(f"{name}: only {finite:.2f} of the rows scored")
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    cells = cells_of(cands["n"], lq, band)
    bound_ms, bound_by = bound(cells, "i16" if name == "banded_i16" else "f32", nbytes(*args, got))
    _report(name, f"lq={lq} band={band} B={num_cands}", err, ms, plain_ms, cells, bound_ms, bound_by)
    return err, ms, plain_ms, bound_ms, bound_by


def host_window_inputs(device):
    """(lq, band) -> (gathered-scorer arguments, host-window rows), both on
    the card: candidates over a 4.6 Mb reference, their query rows and
    windows gathered on the card and laid out as `banded_scores` lays them."""
    import numpy as np
    import torch

    from mapper_tpu_torch.align import banded
    from mapper_tpu_torch.simulate import scoring_candidates

    inputs = {}
    for (lq, band), (num_cands, seed) in HOST_WINDOW_SHAPES.items():
        cands = scoring_candidates(
            np.random.default_rng(seed), num_cands, lq, band, ref_size=4_600_000, num_reads=4096
        )
        args = banded._normalize(*[torch.as_tensor(cands[k]).to(device) for k in _KEYS])
        reads, concat, read_id, reversed_, win_start, _, n, m = args
        q, w = banded._gather_codes(reads, concat, read_id, reversed_, win_start, n, band)
        inputs[(lq, band)] = (args, banded._host_rows(q, w, n, m, band, CHUNK))
    return inputs


def _report(name, shape, err, ms, plain_ms, cells, bound_ms, bound_by):
    print(
        f"[kernel] {name} {shape}: max_abs_err={err} kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {cells / ms / 1e6:.2f} Gcells/s, bound {bound_ms:.4f} ms "
        f"({bound_by}), {bound_ms / ms:.3f} of it",
        flush=True,
    )


def in_turns(calls: dict) -> dict:
    """Each call's CUDA-event times (`cuda_ms`, 20 calls a reading), read in
    turns, forward then back (A B B A): {name: [readings]}."""
    times = {name: [] for name in calls}
    for name in [*calls, *reversed(calls)]:
        times[name].append(cuda_ms(calls[name], 20))
    return times


def compare_host_row_kernels(params, inputs) -> tuple[dict, dict, object]:
    """K3, K4 and K5 against their plain versions on the card, at the
    host-window path's shapes: K3 on the band-64 rows of width 192 (256
    padded), timed in turns with banded_i16 on the same candidates (the
    route `banded_scores` takes at band 64 follows this pair); K4 and K5 on
    the rows of width 1024 at bands 64 and 128, timed in turns with each
    other; the block K5 at band 32 (outside WARP_BANDS) on the band-64 rows.
    Returns ({name: (max |difference|, kernel ms, plain ms, bound ms, what
    bounds it)} at the main shapes (K4 and K5 at band 128), {name: extra
    keys of its kernels entry}, the plain f32 scores of the width-1024,
    band-128 rows)."""
    import torch

    from mapper_tpu_torch.align import banded, kernels

    results, extra = {}, {}
    q, w, n, m = inputs[(192, 64)][1]
    quant = banded._quantize_params(params, q.shape[1], 64)
    if quant is None:
        raise AssertionError("banded_i16_packed: the quantizer chose f32 at width 256")
    scale, ints = quant
    qi, wi = q.to(torch.int32), w.to(torch.int32)

    def packed():
        return kernels.banded_i16_packed(q, w, n, m, ints, banded._inv(scale))

    def packed_plain():
        return banded._from_units(*banded._pen_core_i16(qi, wi, n, m, ints, 64), scale)

    got, want = packed(), packed_plain()
    torch.cuda.synchronize()
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    if not all(torch.equal(g, p) for g, p in zip(got, want)):
        raise AssertionError(f"banded_i16_packed: kernel != plain (max error {err})")

    # band 64 on the same candidates, timed in turns (A B C C B A): banded_i16
    # on the gathered path, banded_i16 on the host rows, banded_i16_packed
    args = inputs[(192, 64)][0]
    rows = banded._rows_as_candidates(q, w, n, m)
    times = in_turns({
        "banded_i16 gathered": lambda: kernels.banded_i16(*args, ints, banded._inv(scale), 64),
        "banded_i16 host rows": lambda: kernels.banded_i16(*rows, ints, banded._inv(scale), 64),
        "banded_i16_packed host rows": packed,
    })
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    print(f"[kernel] band 64, same {q.shape[0]} candidates, in turns: " + ", ".join(
        f"{name} {mean[name]:.4f} ms" for name in times
    ), flush=True)
    cells = cells_of(n, q.shape[1], 64)
    results["banded_i16_packed"] = (
        err, mean["banded_i16_packed host rows"], cuda_ms(packed_plain, 2),
        *bound(cells, "i16", nbytes(q, w, n, m, *got)),
    )
    _report("banded_i16_packed", f"lq={q.shape[1]} band=64 B={q.shape[0]}", *results["banded_i16_packed"][:3],
            cells, *results["banded_i16_packed"][3:])
    # banded_scores sends int16 rows at band 64 to banded_i16_packed, chosen
    # over banded_i16 by these turns (PERF.md)
    extra["banded_i16_packed"] = {
        "serves": "banded_scores, variant pen, int16 rows at band 64",
        "faster_than_banded_i16_on_the_same_rows": mean["banded_i16_packed host rows"] < mean["banded_i16 host rows"],
        "in_turns_ms": times,
    }

    params6 = banded._params_tuple(params)
    f32_plain = {}
    by_band = {"banded_chunk_f32": {}, "banded_roll_f32": {}}
    for band in (64, 128):
        q, w, n, m = inputs[(1024, band)][1]
        if banded._quantize_params(params, q.shape[1], band) is not None:
            raise AssertionError(f"the host-window f32 rows quantize at width 1024, band {band}")
        qi, wi = q.to(torch.int32), w.to(torch.int32)

        def plain(qi=qi, wi=wi, n=n, m=m, band=band):
            return banded._pen_core(qi, wi, n, m, params6, band)[0]

        want = f32_plain[band] = plain()
        plain_ms = cuda_ms(plain, 1)  # K4's and K5's plain version is one function
        f32_kernels = {
            "banded_chunk_f32": lambda q=q, w=w, n=n, m=m, band=band: kernels.banded_chunk_f32(
                q, w, n, m, params6, band, CHUNK),
            "banded_roll_f32": lambda q=q, w=w, n=n, m=m, band=band: kernels.banded_roll_f32(
                q, w, n, m, params6, band),
        }
        errs = {}
        for name, kernel in f32_kernels.items():
            got = kernel()
            torch.cuda.synchronize()
            errs[name] = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name} band {band}: kernel != plain (max error {errs[name]})")
            if float((got < 1e8).float().mean()) < 0.5:
                raise AssertionError(f"{name} band {band}: fewer than half of the rows scored")
        # K4 and K5 on the same rows in turns (A B B A): each kernel's time
        # is the mean of its two readings
        times = in_turns(f32_kernels)
        print(f"[kernel] lq={q.shape[1]} band={band}, same {q.shape[0]} rows, in turns: " + ", ".join(
            f"{name} {' '.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items()
        ), flush=True)
        cells = cells_of(n, q.shape[1], band)
        for name, ts in times.items():
            row = (errs[name], sum(ts) / len(ts), plain_ms, *bound(cells, "f32", nbytes(q, w, n, m, want)))
            by_band[name][band] = {"ms": row[1], "plain_ms": row[2], "bound_ms": row[3], "in_turns_ms": ts}
            if band == 128:
                results[name] = row
            _report(name, f"lq={q.shape[1]} band={band} B={q.shape[0]}", *row[:3], cells, *row[3:])

    # the block K5, at a band outside WARP_BANDS, on the band-64 rows
    q, w, n, m = inputs[(1024, 64)][1]
    got = kernels.banded_roll_f32(q, w, n, m, params6, 32)
    want = banded._pen_core(q.to(torch.int32), w.to(torch.int32), n, m, params6, 32)[0]
    torch.cuda.synchronize()
    block_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"banded_roll_f32 band 32 (block kernel): kernel != plain (max error {block_err})")
    block_ms = cuda_ms(lambda: kernels.banded_roll_f32(q, w, n, m, params6, 32), 5)
    print(f"[kernel] banded_roll_f32 lq={q.shape[1]} band=32 (block kernel) B={q.shape[0]}: "
          f"max_abs_err={block_err} kernel {block_ms:.4f} ms, equal to the plain version", flush=True)
    for name in by_band:
        extra[name] = {"by_band": by_band[name]}
    extra["banded_roll_f32"]["block_band_32"] = {"max_abs_err": block_err, "ms": block_ms}
    return results, extra, f32_plain[128]


def host_window_phase(params, inputs, kernels, f32_plain) -> dict:
    """The host-window path, `banded_scores` in every variant, with the
    launch counts set to 0 just before it and read just after; then its
    checks, "roll", "chunk" and "pen" f32 against `f32_plain`, the plain
    version's scores of the width-1024, band-128 rows.  Returns the launch
    counts."""
    import torch

    from mapper_tpu_torch.align import banded

    # the gathered scorer's results, outside the counted run
    gathered = {
        (lq, band): banded.banded_scores_gathered(*args, params, band)
        for (lq, band), (args, _) in inputs.items()
    }
    f32_rows = inputs[(1024, 128)][1]
    kernels.reset_launches()
    pen = {
        (lq, band): banded.banded_scores(*rows, params, band=band, chunk=CHUNK, return_diag_sums=True)
        for (lq, band), (_, rows) in inputs.items()
    }
    roll = banded.banded_scores(*f32_rows, params, band=128, chunk=CHUNK, variant="roll")
    chunk = banded.banded_scores(*f32_rows, params, band=128, chunk=CHUNK, variant="chunk")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"[host-window] kernel launches in the host-window path: {launches}", flush=True)
    for name in REPLACES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the host-window path")

    # banded_i16 on the band-64 rows, outside the counted run
    rows = inputs[(192, 64)][1]
    scale, ints = banded._quantize_params(params, rows[0].shape[1], 64)
    unpacked_diag = torch.empty((rows[0].shape[0], 64), dtype=torch.float32, device=rows[0].device)
    unpacked = kernels.banded_i16(
        *banded._rows_as_candidates(*rows), ints, banded._inv(scale), 64, diag_out=unpacked_diag
    )[0]

    for (lq, band), (args, _) in inputs.items():
        scores, diag = pen[(lq, band)]
        lane = torch.clamp(args[5], 0, band - 1)
        picked = diag[torch.arange(diag.shape[0], device=diag.device), lane]
        ref = gathered[(lq, band)]
        if not (torch.equal(scores, ref[0]) and torch.equal(picked, ref[1])):
            raise AssertionError(f"pen rows at width {lq}, band {band} != the gathered scorer")
        scored = float((scores < 1e8).float().mean())
        if scored < 0.5:
            raise AssertionError(f"pen rows at width {lq}, band {band}: only {scored:.2f} scored")
        print(
            f"[host-window] pen lq={lq} band={band}: scores and diagonal sums at each lane "
            f"equal to the gathered scorer ({scored:.4f} of rows scored)",
            flush=True,
        )
    if not all(torch.equal(a, b) for a, b in zip(pen[(192, 64)], (unpacked, unpacked_diag))):
        raise AssertionError("packed band-64 scores or diagonal sums != banded_i16 on the same rows")
    print("[host-window] packed band 64: scores and diagonal sums equal to banded_i16 on the "
          "same rows", flush=True)
    for variant, scores in (("roll", roll), ("chunk", chunk), ("pen", pen[(1024, 128)][0])):
        if not torch.equal(scores, f32_plain):
            raise AssertionError(f"{variant} f32 scores at width 1024 != the plain version")
    print("[host-window] lq=1024 band=128: roll, chunk and pen f32 equal to the plain version, "
          "bit for bit", flush=True)
    return launches


# one PyTorch call that computes a probe body's function (its yardstick,
# `library_ms`), where one exists; the port calls none of them
PROBE_LIBRARY = {
    ("a", "copy"): lambda x: x.clone(),
    ("a", "widen_reduce"): lambda x: x.amin(dim=1, keepdim=True),
    ("a", "narrow_out"): lambda x: x[:, :1].clone(),
    ("a", "scratch_i16"): lambda x: x.clone(),
    ("b", "add_only_scalar"): lambda x: x + 3,
    ("b", "min_only_scalar"): lambda x: x.clamp(max=90),
    ("c", "reduce_i32"): lambda x: x.amin(dim=1, keepdim=True),
    ("e", "sub"): lambda x: x - 3,
    ("e", "shr"): lambda x: x >> 15,
    ("e", "band"): lambda x: x & 7,
    ("e", "vec_add"): lambda x: x + x,
    ("g", "reduce"): lambda x: x.amin(dim=1, keepdim=True),
}

# the part of its input a probe body's function reads, where it is not all
PROBE_READS = {("a", "narrow_out"): lambda x: x[:, :1]}


def compare_probes(device) -> dict:
    """Every probe body's kernel against its plain version on the card,
    exactly, at [64, 128] (the probes' own input and a seeded one over the
    whole int16 range) and at [PROBE_ROWS, 128]; each timed at the larger
    shape by CUDA-graph replay (`graph_ms`), device time without the host's
    pace, in turns with its one-call yardstick where `PROBE_LIBRARY` has one
    (held equal to the plain version first), beside its byte bound.  Returns {stage:
    (max |difference|, kernel ms, plain ms, bound ms, library ms or None,
    bodies with a library call, per-body rows)}, the times summed over the
    stage's bodies (the library time over those that have one)."""
    import numpy as np
    import torch

    from mapper_tpu_torch.probe_i16 import probes

    rng = np.random.default_rng(0)

    def block(rows):
        return torch.from_numpy(rng.integers(-2**15, 2**15, (rows, probes.B)).astype(np.int16)).to(device)

    big = block(PROBE_ROWS)
    blocks = [probes.probe_input(device), block(probes.T), big]
    results = {}
    for stage, bodies in probes.STAGES.items():
        err, ms, plain_ms, bound_ms, library_ms, rows = 0.0, 0.0, 0.0, 0.0, 0.0, []
        for body in bodies:
            for x in blocks:
                got, want = probes.run(stage, body, x), probes.plain(stage, body, x)
                torch.cuda.synchronize()
                err = max(err, float((got.to(torch.int32) - want.to(torch.int32)).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"probe {stage}.{body}: kernel != plain at {tuple(x.shape)}")
            out = probes.plain(stage, body, big)

            def kernel():
                return probes.run(stage, body, big)

            row = {
                "body": body,
                "plain_ms": graph_ms(lambda: probes.plain(stage, body, big), 20),
                "bound_ms": nbytes(PROBE_READS.get((stage, body), lambda x: x)(big), out)
                / MEM_BYTES_PER_S * 1e3,
                "library_ms": None,
            }
            library = PROBE_LIBRARY.get((stage, body))
            if library is None:
                row["ms"] = graph_ms(kernel, 20)
            else:
                if not torch.equal(library(big), out):
                    raise AssertionError(f"probe {stage}.{body}: the library call != plain")
                # kernel and library call in turns (A B B A), each reading one
                # replay of PROBE_TURN_CALLS calls; the means are the row's
                turns = {"ms": [], "library_ms": []}
                pair = (("ms", kernel), ("library_ms", lambda: library(big)))
                for key, fn in (*pair, *reversed(pair)):
                    turns[key].append(graph_ms(fn, PROBE_TURN_CALLS))
                row.update({key: sum(v) / len(v) for key, v in turns.items()}, turns=turns)
                library_ms += row["library_ms"]
            ms, plain_ms, bound_ms = ms + row["ms"], plain_ms + row["plain_ms"], bound_ms + row["bound_ms"]
            rows.append(row)
            print(
                f"[probe-body] {stage}.{body} [{PROBE_ROWS}, {probes.B}]: kernel {row['ms'] * 1e3:.3f} us, "
                f"plain {row['plain_ms'] * 1e3:.2f} us, library "
                + ("none" if library is None else
                   f"{row['library_ms'] * 1e3:.3f} us (in turns: kernel/library {row['ms'] / row['library_ms']:.3f})")
                + f", bound {row['bound_ms'] * 1e3:.2f} us (bytes), {row['bound_ms'] / row['ms']:.3f} of it",
                flush=True,
            )
        with_library = sum(r["library_ms"] is not None for r in rows)
        results[stage] = (err, ms, plain_ms, bound_ms, library_ms if with_library else None, with_library, rows)
        print(
            f"[kernel] probe_i16_{stage} ({len(bodies)} bodies) [{PROBE_ROWS}, {probes.B}]: "
            f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
            f"library {library_ms:.4f} ms over {with_library} bodies (sums over the bodies, CUDA-graph replay)",
            flush=True,
        )
    return results


def probe_phase(kernels) -> dict:
    """The probe path: the entry point `python -m mapper_tpu_torch.probe_i16
    <stage>` for every stage, in this process with the launch counts set to 0
    just before and read just after, then as nine subprocesses started
    together.  Returns the launch counts."""
    from mapper_tpu_torch.probe_i16 import probes
    from mapper_tpu_torch.probe_i16.__main__ import main as probe_main

    os.environ["MAPPER_TPU_TORCH_DEVICE"] = "cuda"
    kernels.reset_launches()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rcs = {stage: probe_main([stage]) for stage in probes.STAGES}
    launches = dict(kernels.LAUNCHES)
    print(f"[probe] kernel launches in the probe path: {launches}", flush=True)
    oks = printed.getvalue().count(": OK exact")
    if any(rcs.values()) or oks != sum(map(len, probes.STAGES.values())):
        raise AssertionError(f"probe entry: exit codes {rcs}\n{printed.getvalue()}")
    for stage in probes.STAGES:
        if launches[f"probe_i16_{stage}"] <= 0:
            raise AssertionError(f"probe_i16_{stage} was not launched by the probe path")
    print(f"[probe] in-process: {oks} bodies OK exact", flush=True)

    t0 = time.time()
    env = dict(os.environ, MAPPER_TPU_TORCH_DEVICE="cuda")
    procs = {
        stage: subprocess.Popen(
            [sys.executable, "-m", "mapper_tpu_torch.probe_i16", stage],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for stage in probes.STAGES
    }
    try:
        outs = {stage: proc.communicate(timeout=300)[0] for stage, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for stage, proc in procs.items():
        if proc.returncode != 0 or outs[stage].count(": OK exact") != len(probes.STAGES[stage]):
            raise AssertionError(f"probe stage {stage} exited {proc.returncode}:\n{outs[stage][-2000:]}")
    print(f"[probe] nine subprocesses exited 0 in {time.time() - t0:.1f} s", flush=True)
    return launches


def simulate_inputs(root: Path, ref_size: int, num_short: int, num_long: int, num_pairs: int,
                    num_split: int, seed: int = 0):
    import numpy as np

    from benchmarks.simlib import random_reference, simulate_paired, write_reference
    from mapper_tpu_torch.simulate import simulate_reads, write_fastq

    rng = np.random.default_rng(seed)
    ref = random_reference(rng, ref_size)
    write_reference(str(root / "ref.fasta"), {"chr1": ref})
    write_fastq(root / "short.fastq", simulate_reads(rng, ref, num_short, 150, 0.01, 0.1, "s"))
    write_fastq(root / "long.fastq", simulate_reads(rng, ref, num_long, 1000, 0.01, 0.1, "l"))
    # config 3's pairs (benchmarks/bench_config3_pe.py) and reads to split
    simulate_paired(str(root / "pairs_1.fasta"), str(root / "pairs_2.fasta"), ref, num_pairs, seed=7)
    write_fastq(root / "split.fastq", simulate_reads(rng, ref, num_split, 3000, 0.01, 0.1, "q"))


# the CLI runs' query arguments, input files named relative to the run's root
SHORT = ["--queries", "short.fastq"]
LONG = ["--queries", "long.fastq"]
PAIRED = ["--paired-queries", "pairs_1.fasta", "pairs_2.fasta", "--spacing", "100", "50"]
SPLIT = ["--split-queries-past-size", "1500", "--queries", "split.fastq"]
# BASELINE configs 4 and 5, each under a directory of its own with its
# reference as ref.fasta (benchmarks/bench_config4_metagenomic.py,
# bench_config5_longreads.py); the split flag precedes the --queries it
# applies to (Mapper.java:102-104)
CONFIG4 = ["--paired-queries", "reads_1.fasta", "reads_2.fasta", "--spacing", "100", "50"]
CONFIG4_OUTPUTS = ("refs", "sam", "unaligned")
CONFIG4_PAIRS = 20_000  # the config's 1,000,000 pairs, cut for the smoke's time
CONFIG5 = ["--split-queries-past-size", "1500", "--queries", "reads.fasta", "--infer-ancestors"]
CONFIG5_OUTPUTS = ("sam", "unaligned")
CONFIG5_READS = 200  # the config's 2,000 reads, cut for the smoke's time


def simulate_config4(root: Path) -> None:
    """Config 4 as `bench_config4_metagenomic.py:23-52` builds it: 4 random
    genomes of 1 Mb (seed 4), pairs drawn abundance-skewed 2^-g, simulated
    per genome (seed 40 + g) and concatenated."""
    import numpy as np

    from benchmarks import simlib

    root.mkdir()
    rng = np.random.default_rng(4)
    genomes = {f"genome{g}": simlib.random_reference(rng, 1_000_000) for g in range(4)}
    simlib.write_reference(str(root / "ref.fasta"), genomes)
    weights = np.array([2.0 ** -g for g in range(4)])
    weights /= weights.sum()
    counts = np.floor(weights * CONFIG4_PAIRS).astype(int)
    counts[0] += CONFIG4_PAIRS - counts.sum()
    parts = []
    for g, text in enumerate(genomes.values()):
        p1, p2 = root / f"g{g}_1.fasta", root / f"g{g}_2.fasta"
        simlib.simulate_paired(str(p1), str(p2), text, int(counts[g]), seed=40 + g)
        parts.append((p1, p2))
    for mate in (0, 1):
        (root / f"reads_{mate + 1}.fasta").write_text("".join(pair[mate].read_text() for pair in parts))


def simulate_config5(root: Path) -> None:
    """Config 5 as `bench_config5_longreads.py:24-43` builds it: a 10 Mb
    reference (seed 5) whose last 150 kb are three copies of its first 50
    kb at 2% SNPs, and reads of 10 kb at 2% SNPs (seed 5)."""
    import numpy as np

    from benchmarks import simlib

    root.mkdir()
    rng = np.random.default_rng(5)
    base = simlib.random_reference(rng, 10_000_000 - 150_000)
    segment = np.array(list(base[:50_000]))
    ref_text = base + "".join("".join(simlib.mutate(rng, segment, 0.02)) for _ in range(3))
    simlib.write_reference(str(root / "ref.fasta"), {"chr1": ref_text})
    simlib.simulate_single(str(root / "reads.fasta"), ref_text, CONFIG5_READS, read_length=10_000,
                           snp_rate=0.02, seed=5)


# the CLI's five outputs: name -> (flag, file name)
OUTPUTS = {
    "sam": ("--out-sam", "out.sam"), "vcf": ("--out-vcf", "out.vcf"),
    "mutations": ("--out-mutations", "mutations.txt"), "refs": ("--out-refs-map-count", "refs.txt"),
    "unaligned": ("--out-unaligned", "unaligned.fastq"),
}


def run_cli(root: Path, query_args: list[str], tag: str, on_cpu: bool = False,
            outputs: tuple[str, ...] = tuple(OUTPUTS)) -> dict:
    """One CLI run against `root`/ref.fasta on the card, or with `on_cpu` on
    the CPU (the kernels' plain versions), writing `outputs` (all five by
    default); returns their bytes and the align-phase numbers."""
    from mapper_tpu_torch import cli

    out = root / tag
    out.mkdir()
    args = [
        "--reference", str(root / "ref.fasta"),
        *(str(root / a) if a.endswith((".fasta", ".fastq")) else a for a in query_args),
        *(x for name in outputs for x in (OUTPUTS[name][0], str(out / OUTPUTS[name][1]))),
        "--cache-dir", str(root / "index_cache"),
    ]
    os.environ["MAPPER_TPU_TORCH_DEVICE"] = "cpu" if on_cpu else "cuda"
    log = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stderr(log):
            rc = cli.main(args)
    finally:
        os.environ["MAPPER_TPU_TORCH_DEVICE"] = "cuda"
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"{tag}: CLI returned {rc}\n{log.getvalue()[-3000:]}")
    m = re.search(r"Align phase: (\d+) queries in ([0-9.]+)s", log.getvalue())
    if m is None:
        raise AssertionError(f"{tag}: no align-phase line\n{log.getvalue()[-3000:]}")
    num, seconds = int(m.group(1)), float(m.group(2))
    files = {name: (out / OUTPUTS[name][1]).read_bytes() for name in outputs}
    unaligned_text = files["unaligned"].decode()
    # FASTA input writes FASTA records, FASTQ input FASTQ ones
    if unaligned_text.startswith(">"):
        unaligned = sum(line.startswith(">") for line in unaligned_text.splitlines())
    else:
        unaligned = unaligned_text.count("\n") // 4
    counted = re.search(r"Device pileup: (\d+) rows", log.getvalue())
    fused = re.search(r"Device candidates: (\d+) of (\d+) single-end chunks", log.getvalue())
    result = {
        "files": files,
        "device_pileup_rows": None if counted is None else int(counted.group(1)),
        "fused_chunks": None if fused is None else (int(fused.group(1)), int(fused.group(2))),
        "queries": num,
        "unaligned_records": unaligned,
        "aligned_fraction": 1.0 - unaligned / num,
        "align_seconds": seconds,
        "wall_seconds": wall,
    }
    print(
        f"[cli] {tag}: {num} queries, {unaligned} unaligned records, "
        f"align phase {seconds:.3f} s = {num / seconds:.1f} reads/s, run {wall:.1f} s",
        flush=True,
    )
    return result


def cli_phase(root: Path, kernels) -> tuple[dict, dict, dict]:
    """The CLI path: kernel-scored CLI runs (launches counted) and their
    CPU-scored twins (which launch nothing).  The main path is the first:
    100,000 single-end 150 bp reads, the default CLI run, its launch counts
    read around it alone.  Returns the launch counts of the main path and of
    both kernel runs, and the runs by tag."""
    kernels.reset_launches()
    short = run_cli(root, SHORT, "short_kernel")
    main_launches = dict(kernels.LAUNCHES)
    print(f"[cli] kernel launches in the main path (100,000 reads of 150 bp): {main_launches}", flush=True)
    if main_launches["banded_i16"] <= 0:
        raise AssertionError("banded_i16 was not launched by the main path")
    long_ = run_cli(root, LONG, "long_kernel")
    launches = dict(kernels.LAUNCHES)
    print(f"[cli] kernel launches in both kernel-scored CLI runs: {launches}", flush=True)
    for name in ("banded_i16", "banded_f32"):  # the engine's gathered scorer
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the CLI runs")
    for run in (short, long_):
        if run["aligned_fraction"] < 0.99:
            raise AssertionError(f"aligned fraction {run['aligned_fraction']} < 0.99")
    kernels.reset_launches()
    short_cpu = run_cli(root, SHORT, "short_cpu", on_cpu=True)
    long_cpu = run_cli(root, LONG, "long_cpu", on_cpu=True)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the CPU-scored runs launched kernels: {kernels.LAUNCHES}")
    print("[cli] CPU-scored runs launched no kernel", flush=True)
    for kernel_run, cpu_run, tag in ((short, short_cpu, "short"), (long_, long_cpu, "long")):
        same_outputs(kernel_run, cpu_run, f"{tag}: the kernel-scored run vs the CPU-scored run")
    runs = {"short_kernel": short, "long_kernel": long_, "short_cpu": short_cpu, "long_cpu": long_cpu}
    return main_launches, launches, runs


def same_outputs(run: dict, twin: dict, what: str) -> None:
    """Raises unless two runs wrote the same outputs, each byte-identical,
    with the first differing lines."""
    if run["files"].keys() != twin["files"].keys():
        raise AssertionError(f"{what}: outputs {sorted(run['files'])} against {sorted(twin['files'])}")
    for out, data in run["files"].items():
        if data != twin["files"][out]:
            diff = difflib.unified_diff(
                twin["files"][out].decode().splitlines(), data.decode().splitlines(), lineterm="", n=0
            )
            shown = "\n".join(line[:300] for line in itertools.islice(diff, 12))
            raise AssertionError(f"{what}: {out} differs:\n{shown}")
    print(f"[cli] {what}: {', '.join(run['files'])} byte-identical", flush=True)


def device_pileup_phase(root: Path, kernels, short: dict) -> dict:
    """The 100,000-read run again with the pileup accumulated on the card,
    launch counts read around it; SAM, VCF and mutations must equal the run
    without it.  Returns the launch counts."""
    kernels.reset_launches()
    os.environ["MAPPER_TPU_DEVICE_PILEUP"] = "1"
    try:
        run = run_cli(root, SHORT, "short_device_pileup")
    finally:
        os.environ.pop("MAPPER_TPU_DEVICE_PILEUP", None)
    launches = dict(kernels.LAUNCHES)
    print(f"[pileup] kernel launches in the device-pileup run: {launches}", flush=True)
    if launches["banded_i16"] <= 0:
        raise AssertionError("banded_i16 was not launched by the device-pileup run")
    rows = run["device_pileup_rows"]
    if not rows:
        raise AssertionError(f"no rows were counted on the device: {rows}")
    same_outputs(run, short, "device pileup: the device-pileup run vs the host-pileup run")
    print(f"[pileup] {rows} rows counted on the card ({rows / run['queries']:.4f} of reads)", flush=True)
    return launches


def load_database(root: Path):
    """The reference's index as the CLI builds it (the same sizes), read from
    the CLI runs' index cache."""
    from mapper_tpu_torch.index.database import HashBlockDatabase, choose_max_duplication_length
    from mapper_tpu_torch.index.dircache import DirCache
    from mapper_tpu_torch.io import fastx
    from mapper_tpu_torch.sequence import SequenceDatabase, sort_and_complement

    provider = fastx.load_from([str(root / "ref.fasta")], keep_quality=False)
    seq_db = SequenceDatabase(sort_and_complement(b.build() for b in provider))
    return HashBlockDatabase(
        seq_db, hint_max_interesting_size=choose_max_duplication_length(seq_db),
        cache_dir=DirCache(str(root / "index_cache")),
    )


def candidate_columns(table, skip) -> list:
    import numpy as np

    keep = ~np.isin(table.read_id, np.asarray(skip, dtype=np.int64))
    return [np.asarray(c)[keep] for c in (table.read_id, table.reversed_, table.ref_seq_index,
                                          table.offset, table.votes)]


def dc_batches(root: Path) -> dict:
    """The device-candidates kernels' workloads, each one chunk of the CLI's
    path: the first DC_READS reads of the 150 bp run, the 2,000 reads of
    1,000 bp, the mates of the first DC_READS / 2 pairs of the paired run
    as single reads, and one read of 5,000 bp from the reference (its row
    takes KC1's scratch buffer)."""
    import numpy as np

    from mapper_tpu_torch.batch.candidates import ReadBatch
    from mapper_tpu_torch.sequence import Sequence

    def fastq(name, limit=None):
        lines = (root / name).read_text().splitlines()[: None if limit is None else 4 * limit]
        return [Sequence.from_text(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]

    mates = []
    for k in (1, 2):
        lines = (root / f"pairs_{k}.fasta").read_text().splitlines()[: DC_READS]
        mates.extend(Sequence.from_text(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 2))
    ref = "".join((root / "ref.fasta").read_text().splitlines()[1:])
    pos = int(np.random.default_rng(9).integers(0, len(ref) - 5000))
    return {
        "150bp": ReadBatch.from_sequences(fastq("short.fastq", DC_READS)),
        "1000bp": ReadBatch.from_sequences(fastq("long.fastq")),
        "paired_mates": ReadBatch.from_sequences(mates),
        "5000bp": ReadBatch.from_sequences([Sequence.from_text("ref5000", ref[pos : pos + 5000])]),
    }


def dc_work(inputs) -> dict:
    """What this run's data asks of KC1, counted from the plain program's
    pieces: the valid bases; the blocks entering each level and those left
    after its merge; the seeds that pass the size filter, and the kept ones
    (the first V_SLOTS); the values that each kept seed's lookup must read,
    up to the P_SLOTS vote slots; the vote entries before and after P_SLOTS
    clips them; and a sort's n log2 n compares over each read's entries."""
    import torch

    from mapper_tpu_torch.batch import device_candidates as dc

    codes, lengths, index = inputs["codes"], inputs["lengths"], inputs["index"]
    valid0 = torch.arange(codes.shape[1], device=codes.device)[None, :] < lengths[:, None]
    row = dc._base_row(codes, valid0, index["two_bit"])
    entering = merged = 0
    for _ in range(dc.NUM_LEVELS):
        entering += int(row["valid"].sum())
        row = dc._merge_row_device(row)
        merged += int(row["valid"].sum())
    seeds = dc._plain_seeds(inputs)
    matches = seeds["matches"]
    # each kept seed's values that land in the P_SLOTS vote slots
    needed = torch.minimum(torch.clamp(dc.P_SLOTS - (torch.cumsum(matches, dim=1) - matches), min=0), matches)
    entries = needed.sum(dim=1).double()
    return {
        "bases": int(lengths.sum()), "blocks": entering, "merged_blocks": merged,
        "seeds": int(seeds["seeds"].sum()), "kept_seeds": int(seeds["valid"].sum()),
        "lookups": int((needed > 0).sum()),
        "value_sectors": int(((needed * 4 + SECTOR_BYTES - 1) // SECTOR_BYTES).sum()),
        "vote_entries": int(matches.sum()), "kept_entries": int(entries.sum()),
        "compares": float((entries * torch.log2(entries.clamp(min=1))).sum()),
    }


def dc_bounds(inputs, work: dict, band_rows: int, kept_rows: int, k_out: int = 8) -> dict:
    """KC1's and KC2's least times on the card for this run's work: the
    larger of their bytes over the memory rate and their operations
    (`KC1_OPS`, `KC2_OPS`) over the int32 rate.  KC1 reads each read's codes
    and length once, one sector for each kept seed's bin count, and for each
    seed that votes one sector for its offset and the sectors of its
    contiguous values, and writes the [B, 2K+1] table; KC2 reads the table
    and the per-read lengths and half-windows, writes `band_rows` rows of
    read, strand, window start, lane, n and m (33 bytes)."""
    import math

    codes = inputs["codes"]
    b, width = codes.shape
    search = math.ceil(math.log2(inputs["index"]["seq_starts_tail"].shape[0] + 1))
    table_bytes = b * (2 * k_out + 1) * 4
    kc1_bytes = (b * width + b * 8 + SECTOR_BYTES * (work["kept_seeds"] + work["lookups"] + work["value_sectors"])
                 + table_bytes)
    kc1_ops = (KC1_OPS["base"] * work["bases"] + KC1_OPS["merge"] * work["blocks"]
               + KC1_OPS["gapmer"] * work["merged_blocks"] + KC1_OPS["seed"] * work["kept_seeds"]
               + (KC1_OPS["entry"] + KC1_OPS["search_step"] * search + KC1_OPS["vote"]) * work["kept_entries"]
               + KC1_OPS["compare"] * work["compares"])
    kc2_bytes = table_bytes + 2 * b * 8 + 33 * band_rows
    kc2_ops = KC2_OPS["entry"] * b * k_out + KC2_OPS["row"] * kept_rows
    out = {}
    for name, moved, ops in (("candidates", kc1_bytes, kc1_ops), ("fused_rows", kc2_bytes, kc2_ops)):
        bytes_ms, ops_ms = moved / MEM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        out[name] = {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "bytes": moved, "operations": ops}
    return out


def wall_ms(fn, reps: int) -> float:
    """Host-clock milliseconds a call over `reps` calls, synchronized, after
    one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def max_int_err(got, want) -> int:
    """max |got - want| of two integer or boolean tensors, as int64."""
    import torch

    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0


def compare_dc_kernels(tag: str, inputs, band: int) -> dict:
    """KC1 and KC2 against their plain versions on the card on one
    workload, which must be equal (torch.equal, the same dtypes); their
    CUDA-event and host-clock times beside the plain versions' and their
    bounds."""
    import torch

    from mapper_tpu_torch.align import kernels
    from mapper_tpu_torch.batch import device_candidates as dc

    want = dc.candidates_plain(inputs)
    got = dc.candidates_program(inputs)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        differ = int((got != want).any(dim=1).sum())
        raise AssertionError(f"candidates kernel != plain on {tag}: {differ} of {got.shape[0]} reads differ")
    table = got.clone()
    rows = dc.fused_rows(table, inputs, band)
    plain_rows = dc.fused_rows_plain(got, inputs, band)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(rows, plain_rows)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"fused_rows kernel != plain on {tag}: output {i}")
    votes = got[:, 8:16].long()
    kept = int(((votes > 0) & ((votes[:, :1] < 6) | (votes * 3 >= votes[:, :1]))).sum())
    work = dc_work(inputs)
    bounds = dc_bounds(inputs, work, rows[1].shape[0], kept)
    out = {
        "reads": int(got.shape[0]), "width": int(inputs["codes"].shape[1]), "band": band,
        "in_scratch": kernels.candidates_in_scratch(int(inputs["codes"].shape[1])),
        "fallback_reads": int(got[:, -1].sum()), "kept_rows": kept, "scored_rows": int(rows[1].shape[0]),
        **work,
    }
    calls = {
        "candidates": (lambda: dc.candidates_program(inputs), lambda: dc.candidates_plain(inputs),
                       max_int_err(got, want)),
        "fused_rows": (lambda: dc.fused_rows(table, inputs, band), lambda: dc.fused_rows_plain(got, inputs, band),
                       max(max_int_err(a, b) for a, b in zip(rows, plain_rows))),
    }
    for name, (kernel, plain, err) in calls.items():
        # the kernel's device time by graph replay: KC2's few microseconds
        # are below the host's pace of issuing calls, which CUDA events over
        # calls issued one by one would time instead
        ms = graph_ms(kernel, DC_TIMING_CALLS)
        out[name] = {
            "max_abs_err": err, "ms": ms, "events_ms": cuda_ms(kernel, DC_TIMING_CALLS),
            "wall_ms": wall_ms(kernel, DC_TIMING_CALLS),
            "plain_ms": cuda_ms(plain, 3), "plain_wall_ms": wall_ms(plain, 3), **bounds[name],
            "share": bounds[name]["bound_ms"] / ms,
        }
        print(f"[device-candidates] {tag} {name}: equal to plain; kernel {ms:.4f} ms (CUDA-graph replay; "
              f"{out[name]['events_ms']:.4f} ms CUDA events, "
              f"{out[name]['wall_ms']:.4f} ms host clock), plain {out[name]['plain_ms']:.4f} ms "
              f"({out[name]['plain_wall_ms']:.4f} ms), bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']}), {out[name]['share']:.4f} of it", flush=True)
    print(f"[device-candidates] {tag}: {out['reads']} reads, width {out['width']}, band {band}, "
          f"scratch row {out['in_scratch']}, {out['fallback_reads']} flagged, {kept} kept rows "
          f"({out['scored_rows']} scored)", flush=True)
    return out


def busy_python(stop) -> None:
    """Pure-Python work until `stop` is set: it holds the GIL but for the
    interpreter's switch requests."""
    x = 0
    while not stop.is_set():
        for i in range(10_000):
            x += i


def contention_ms(fn, reps: int) -> dict:
    """fn's host-clock milliseconds a call (reps calls, synchronized) alone
    and beside one busy_python thread, in turns: alone, busy, alone."""
    import threading

    import torch

    fn()
    torch.cuda.synchronize()
    readings = {"alone": [], "busy": []}
    for mode in ("alone", "busy", "alone"):
        stop = threading.Event()
        worker = threading.Thread(target=busy_python, args=(stop,)) if mode == "busy" else None
        if worker is not None:
            worker.start()
        try:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            readings[mode].append((time.perf_counter() - t0) / reps * 1e3)
        finally:
            stop.set()
            if worker is not None:
                worker.join()
    return readings


def device_ops(fn, calls: int = 3) -> dict:
    """torch.profiler over `calls` calls of fn: device operations (kernels
    and copies on the card) and device-busy milliseconds a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops, busy_us = 0, 0.0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            ops += 1
            busy_us += event.device_time_total
    return {"device_ops_per_call": ops / calls, "device_busy_ms_per_call": busy_us / calls / 1e3}


def device_candidates_programs(root: Path, params, device) -> dict:
    """The device-candidates kernels and programs on the card, with the
    engine's band and half-windows: KC1 and KC2 against their plain
    versions on each of `dc_batches`' workloads (`compare_dc_kernels`); on
    the 150 bp chunk, the candidates program against the host pass (every
    read not flagged for fallback), the fused program on the card against
    the same program run on the CPU (torch.equal over its whole int32
    output), its CUDA-event and host-clock times beside the plain program's
    on the card, its device operations a call (torch.profiler), its host
    time beside a busy Python thread, and the host pass's wall time.
    Returns the numbers."""
    import numpy as np
    import torch

    from mapper_tpu_torch.align.banded import banded_scores_gathered
    from mapper_tpu_torch.batch import device_candidates as dc
    from mapper_tpu_torch.batch.candidates import generate_candidates
    from mapper_tpu_torch.batch.engine import single_end_band, upload_reference

    t0 = time.time()
    db = load_database(root)
    batches = dc_batches(root)
    concat_np = db.get_sequence_database().concatenated_codes()
    concat = upload_reference(concat_np, device)
    print(f"[device-candidates] index loaded, workloads read in {time.time() - t0:.1f} s", flush=True)
    kernels_numbers, inputs_of = {}, {}
    for tag, batch in batches.items():
        band, shift = single_end_band(batch.lengths, params)
        inputs_of[tag] = (dc.fused_inputs(batch, db, concat, shift, band), band, shift)
        kernels_numbers[tag] = compare_dc_kernels(tag, *inputs_of[tag][:2])

    batch = batches["150bp"]
    inputs, band, shift = inputs_of["150bp"]
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = generate_candidates(batch, db)
        host_s.append(time.perf_counter() - t0)
    table, fallback = dc.generate_candidates_device(batch, db, device)
    for got, want in zip(candidate_columns(table, fallback), candidate_columns(host, fallback)):
        if not np.array_equal(got, want):
            raise AssertionError("device candidates != the host pass on the reads not flagged for fallback")
    print(f"[device-candidates] the candidates program on the card equals the host pass on "
          f"{batch.num_reads - len(fallback)} reads; {len(fallback)} reads flagged for fallback; "
          f"{len(table)} rows", flush=True)

    cpu_inputs = dc.fused_inputs(batch, db, upload_reference(concat_np, torch.device("cpu")), shift, band)
    got = dc.fused_program(inputs, params, band).cpu()
    t0 = time.time()
    want = dc.fused_program(cpu_inputs, params, band)
    cpu_s = time.time() - t0
    if not torch.equal(got, want):
        differ = int((got != want).sum())
        raise AssertionError(f"the fused program on the card != its CPU run ({differ} of {got.numel()} words)")
    print(f"[device-candidates] the fused program's {got.numel()} int32 words on the card equal its CPU run "
          f"(plain scorer, {cpu_s:.1f} s on the host)", flush=True)

    def fused():
        return dc.fused_program(inputs, params, band)

    def fused_plain():  # the same program through the plain versions on the card (the eager program)
        table = dc.candidates_plain(inputs)
        table, *rows = dc.fused_rows_plain(table, inputs, band)
        scores = banded_scores_gathered(inputs["codes"], inputs["concat"], *rows, params, band)
        return torch.cat([table.reshape(-1), scores.reshape(-1).view(torch.int32)])

    if not torch.equal(fused_plain().cpu(), got):
        raise AssertionError("the fused program through the plain versions != through the kernels")
    small = torch.ones(1024, device=device)

    def small_ops():
        for _ in range(200):
            small.add_(1)

    numbers = {
        "reads": batch.num_reads, "band": band, "read_width": int(inputs["codes"].shape[1]),
        "scored_rows": dc.score_rows(batch.num_reads), "candidate_rows": len(table),
        "fallback_reads": int(len(fallback)),
        "candidates_ms": cuda_ms(lambda: dc.candidates_program(inputs), DC_TIMING_CALLS),
        "fused_ms": cuda_ms(fused, DC_TIMING_CALLS), "fused_plain_ms": cuda_ms(fused_plain, 3),
        "candidates_wall_ms": wall_ms(lambda: dc.candidates_program(inputs), DC_TIMING_CALLS),
        "fused_wall_ms": wall_ms(fused, DC_TIMING_CALLS), "fused_plain_wall_ms": wall_ms(fused_plain, 3),
        "fused_profile": device_ops(fused), "fused_plain_profile": device_ops(fused_plain),
        "contention_ms_per_call": {"fused": contention_ms(fused, 20), "200_small_ops": contention_ms(small_ops, 20)},
        "host_candidates_ms": [t * 1e3 for t in host_s],
        "kernels": kernels_numbers,
    }
    print(
        f"[device-candidates] {batch.num_reads} reads: candidates program {numbers['candidates_ms']:.4f} ms "
        f"(CUDA events; {numbers['candidates_wall_ms']:.4f} ms host clock, synchronized), fused program "
        f"{numbers['fused_ms']:.4f} ms ({numbers['fused_wall_ms']:.4f} ms, "
        f"{numbers['fused_profile']['device_ops_per_call']:.0f} device operations, "
        f"{numbers['fused_profile']['device_busy_ms_per_call']:.4f} ms busy), through the plain versions "
        f"{numbers['fused_plain_ms']:.4f} ms ({numbers['fused_plain_wall_ms']:.4f} ms, "
        f"{numbers['fused_plain_profile']['device_ops_per_call']:.0f} device operations), host "
        f"generate_candidates {min(host_s) * 1e3:.3f} ms (best of 3 wall times)",
        flush=True,
    )
    for name, ms in numbers["contention_ms_per_call"].items():
        print(f"[contention] {name}: ms a call alone {ms['alone']}, beside a busy Python thread {ms['busy']}",
              flush=True)
    return numbers


def fused_run(root: Path, kernels, query_args: list[str], tag: str, twin: dict) -> tuple[dict, dict]:
    """One CLI run on the fused path (MAPPER_TPU_DEVICE_CANDIDATES=1),
    launch counts read around it: every single-end chunk takes the fused
    path, KC1 and KC2 launch once a fused chunk, and SAM, VCF and mutations
    equal the CPU-scored twin's.  Returns the
    run and its launch counts."""
    kernels.reset_launches()
    os.environ["MAPPER_TPU_DEVICE_CANDIDATES"] = "1"
    try:
        run = run_cli(root, query_args, tag)
    finally:
        os.environ.pop("MAPPER_TPU_DEVICE_CANDIDATES", None)
    counts = dict(kernels.LAUNCHES)
    fused, chunks = run["fused_chunks"]
    print(f"[device-candidates] {tag}: {fused} of {chunks} single-end chunks fused; launches {counts}", flush=True)
    if not 0 < fused == chunks:
        raise AssertionError(f"{tag}: {fused} of {chunks} single-end chunks took the fused path")
    for name in ("candidates", "fused_rows"):
        if counts[name] != fused:
            raise AssertionError(f"{tag}: {name} launched {counts[name]} times for {fused} fused chunks")
    same_outputs(run, twin, f"{tag}: the fused run vs the CPU-scored run")
    return run, counts


def device_candidates_phase(root: Path, kernels, runs: dict) -> dict:
    """The 150 bp CLI run on the fused path and kernel-scored in turns after
    phase 5's runs (fused, kernel-scored, kernel-scored, fused; the first
    CLI run of the process, phase 5's, is the warm-up), and the 1,000 bp run
    on the fused path once.  Every single-end chunk must take the fused
    path, KC1 and KC2 launch once a fused chunk, and SAM, VCF and mutations
    are byte-identical to the CPU-scored twins.  Returns the launch counts
    of the fused runs summed and the align phases in turn order."""
    launches, align = {}, {}
    turns = [("short_fused", True), ("short_kernel_turn", False), ("short_kernel_turn2", False),
             ("short_fused_turn2", True)]
    align["short"] = []
    for tag, on_fused in turns:
        if on_fused:
            run, counts = fused_run(root, kernels, SHORT, tag, runs["short_cpu"])
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        else:
            run = run_cli(root, SHORT, tag)
            same_outputs(run, runs["short_cpu"], f"{tag}: the kernel-scored run vs the CPU-scored run")
        align["short"].append({"run": tag, "fused": on_fused, "align_s": run["align_seconds"],
                               "wall_s": run["wall_seconds"]})
    run, counts = fused_run(root, kernels, LONG, "long_fused", runs["long_cpu"])
    if counts["banded_f32"] <= 0:
        raise AssertionError("long_fused: banded_f32 was not launched")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    align["long"] = {"fused_align_s": run["align_seconds"],
                     "kernel_scored_align_s": runs["long_kernel"]["align_seconds"]}
    fused_s = [r["align_s"] for r in align["short"] if r["fused"]]
    kernel_s = [r["align_s"] for r in align["short"] if not r["fused"]]
    align["short_fused_over_kernel"] = sum(fused_s) / sum(kernel_s)
    print(f"[device-candidates] 150 bp align phases in turns: "
          + ", ".join(f"{r['run']} {r['align_s']:.3f} s" for r in align["short"])
          + f"; fused / kernel-scored {align['short_fused_over_kernel']:.3f}; 1,000 bp fused "
          f"{align['long']['fused_align_s']:.3f} s, kernel-scored {align['long']['kernel_scored_align_s']:.3f} s",
          flush=True)
    return {"launches": launches, "align": align}


def twin_phase(root: Path, kernels, query_args: list[str], tag: str, kernel: str,
               outputs: tuple[str, ...] = tuple(OUTPUTS)) -> tuple[dict, dict]:
    """One kernel-scored CLI run (launch counts read around it; `kernel` must
    launch) and its CPU-scored twin (no launch), every output byte-identical.
    Returns the kernel run's launch counts and the twin run."""
    kernels.reset_launches()
    run = run_cli(root, query_args, f"{tag}_kernel", outputs=outputs)
    launches = dict(kernels.LAUNCHES)
    print(f"[{tag}] kernel launches: {launches}", flush=True)
    if launches[kernel] <= 0:
        raise AssertionError(f"{kernel} was not launched by the {tag} run")
    if run["aligned_fraction"] < 0.99:
        raise AssertionError(f"{tag}: aligned fraction {run['aligned_fraction']} < 0.99")
    kernels.reset_launches()
    twin = run_cli(root, query_args, f"{tag}_cpu", on_cpu=True, outputs=outputs)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the CPU-scored {tag} run launched kernels: {kernels.LAUNCHES}")
    same_outputs(run, twin, f"{tag}: the kernel-scored run vs the CPU-scored run")
    return launches, twin


# ---- the parallel slice: a mesh of two shards on one card, two processes --

MESH_BATCH_BASES = 2_000_000  # the CLI's batch (its max_bases_per_batch)
# a subprocess of the multi-process CLI: the CLI's entry, then this process's
# kernel launches as JSON on stdout (the JAX package may not be imported)
MULTI_PROCESS_ENTRY = (
    "import json, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['mapper_tpu'] = None\n"
    "from mapper_tpu_torch import cli\n"
    "from mapper_tpu_torch.align import kernels\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print(json.dumps(kernels.LAUNCHES))\n"
    "sys.exit(rc)\n"
)
MULTI_PROCESS_TIMEOUT_S = 300


def sharded_scores_phase(params, inputs, kernels, mesh) -> dict:
    """`parallel.mesh.sharded_banded_scores` on the host-window rows over
    the two-shard mesh, launch counts read around it: each (width, band)
    must launch its kernel once a shard (K3 at width 192, band 64; K1 at
    band 128; K2 at width 1024) and equal `banded_scores` on the whole
    batch.  Returns the launch counts."""
    import torch

    from mapper_tpu_torch.align import banded
    from mapper_tpu_torch.parallel.mesh import sharded_banded_scores

    want = {key: banded.banded_scores(*rows, params, band=key[1], chunk=CHUNK) for key, (_, rows) in inputs.items()}
    kernels.reset_launches()
    got = {key: sharded_banded_scores(mesh, params, key[1])(*rows) for key, (_, rows) in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"[sharded-scores] kernel launches: {launches}", flush=True)
    expected = {"banded_i16_packed": 2, "banded_i16": 2, "banded_f32": 4}
    if any(launches[name] != n for name, n in expected.items()):
        raise AssertionError(f"sharded_banded_scores launches {launches}, expected {expected}")
    for key, scores in got.items():
        if not torch.equal(scores, want[key]):
            raise AssertionError(f"sharded_banded_scores at width {key[0]}, band {key[1]} != banded_scores")
    print("[sharded-scores] every (width, band) over two shards equals banded_scores on the whole batch",
          flush=True)
    return launches


def reference_index(root: Path):
    """The index the CLI aligns against, from the CLI runs' cache, with its
    duplication detector."""
    from mapper_tpu_torch.api import ReferenceIndex
    from mapper_tpu_torch.index.database import choose_max_duplication_length, choose_min_duplication_length
    from mapper_tpu_torch.index.duplication import DuplicationDetector

    db = load_database(root)
    seq_db = db.get_sequence_database()
    dups = DuplicationDetector(db, choose_min_duplication_length(seq_db), choose_max_duplication_length(seq_db),
                               min_num_interesting_copies=2, window_size=1000)
    dups.ensure_detected()
    return ReferenceIndex(seq_db, db, dups)


def cli_batches(path: Path):
    """The queries of a FASTQ file in the CLI's batches (MESH_BATCH_BASES)."""
    from mapper_tpu_torch.align.query import Query
    from mapper_tpu_torch.sequence import Sequence

    lines = path.read_text().splitlines()
    batches, batch, bases = [], [], 0
    for i in range(0, len(lines), 4):
        batch.append(Query(Sequence.from_text(lines[i][1:], lines[i + 1])))
        bases += len(lines[i + 1])
        if bases >= MESH_BATCH_BASES:
            batches.append(batch)
            batch, bases = [], 0
    if batch:
        batches.append(batch)
    return batches


def summaries(results) -> list:
    """Each read's alignments: penalty and components, references named."""
    return [
        None if r is None else tuple(
            tuple((a.get_penalty(), tuple((c.get_sequence_b().name, *c.content_key()[1:])
                                          for c in a.get_components())) for a in alist)
            for alist in r.get_alignments()
        )
        for r in results
    ]


def mesh_engine_phase(root: Path, params, kernels, mesh) -> tuple[dict, dict]:
    """The engine on a two-shard mesh of one card against the one-device
    engine, batch by batch as the CLI batches, in turns (one device, mesh,
    mesh, one device): the 100,000 reads of 150 bp (banded_i16, two launches
    per chunk that reaches the scorer, counted around the first mesh run)
    with a DevicePileup on every engine, the first mesh run's merging to the
    first one-device run's arrays, then the 2,000 reads of 1,000 bp
    (banded_f32).  Every run's summaries must equal the first one-device
    run's.  Returns the first mesh runs' launch counts and the runs' times."""
    import numpy as np
    import torch

    from mapper_tpu_torch.align import banded
    from mapper_tpu_torch.batch.device_pileup import DevicePileup
    from mapper_tpu_torch.batch.engine import BatchAligner
    from mapper_tpu_torch.pileup import MatchDatabase

    device = mesh[0]
    index = reference_index(root)
    seq_db = index.sequence_database
    sharded_calls = []
    inner = banded._gathered_on_mesh

    def counted(mesh_arg, *args):
        sharded_calls.append(len(args[2][0]))
        return inner(mesh_arg, *args)

    def run(engine, batches):
        results = []
        t0 = time.time()
        for batch in batches:
            results += engine.process_batch(batch, notify=False)
        torch.cuda.synchronize()
        return summaries(results), time.time() - t0

    banded._gathered_on_mesh = counted
    launches, times = {}, {}
    try:
        for tag, fastq, kernel in (("short", "short.fastq", "banded_i16"), ("long", "long.fastq", "banded_f32")):
            batches = cli_batches(root / fastq)
            engines = []

            def engine(on_mesh):
                e = BatchAligner(index, params, mesh=mesh) if on_mesh else BatchAligner(index, params, device)
                if tag == "short":
                    e.device_pileup = DevicePileup(seq_db, 0.1, mesh=mesh) if on_mesh else DevicePileup(seq_db, 0.1, device)
                engines.append(e)
                return e

            want, t_one = run(engine(False), batches)
            del sharded_calls[:]
            kernels.reset_launches()
            got, t_mesh = run(engine(True), batches)
            counts = dict(kernels.LAUNCHES)
            # one launch a shard that has rows: two a chunk, one for a chunk of one row
            expected = sum(min(rows, len(mesh)) for rows in sharded_calls)
            print(f"[mesh] {tag}: kernel launches on the mesh {counts}; {len(sharded_calls)} sharded scorer "
                  f"calls ({sum(sharded_calls)} rows)", flush=True)
            if not sharded_calls or counts[kernel] != expected:
                raise AssertionError(f"mesh {tag}: {counts[kernel]} {kernel} launches for "
                                     f"{len(sharded_calls)} sharded scorer calls, expected {expected}")
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            got2, t_mesh2 = run(engine(True), batches)
            want2, t_one2 = run(engine(False), batches)
            for what, other in (("mesh", got), ("second mesh", got2), ("second one-device", want2)):
                differ = [i for i, (x, y) in enumerate(zip(other, want)) if x != y]
                if len(other) != len(want) or differ:
                    raise AssertionError(f"{tag}: {len(differ)} reads of the {what} run differ from the "
                                         f"one-device engine's, first {differ[:5]}")
            times[tag] = {"one_device_s": [t_one, t_one2], "mesh_s": [t_mesh, t_mesh2]}
            aligned = sum(1 for x in want if x and any(x))
            print(f"[mesh] {tag}: {len(want)} reads, {aligned} aligned, every summary of both mesh runs equal to "
                  f"the one-device engine's; in turns one device {t_one:.3f} s, two shards {t_mesh:.3f} s, "
                  f"two shards {t_mesh2:.3f} s, one device {t_one2:.3f} s", flush=True)
            if tag == "short":
                merged = []
                for pileup in (engines[1].device_pileup, engines[0].device_pileup):
                    db = MatchDatabase(0.1)
                    pileup.merge_into(db)
                    merged.append({s.name: p for s, p in db.group_by_position().items()})
                rows = [e.device_pileup.num_rows_accumulated for e in engines[:2]]
                if not rows[0] or rows[0] != rows[1] or merged[0].keys() != merged[1].keys():
                    raise AssertionError(f"mesh pileup: {rows[0]} rows against {rows[1]}")
                for name, p in merged[0].items():
                    if not (np.array_equal(p.middle, merged[1][name].middle)
                            and np.array_equal(p.end, merged[1][name].end)):
                        raise AssertionError(f"mesh pileup of {name} != the one-device pileup")
                print(f"[mesh] DevicePileup on two shards: {rows[0]} rows, merged arrays equal to the one-device "
                      f"pileup's", flush=True)
            del engines
    finally:
        banded._gathered_on_mesh = inner
    return launches, times


def sharded_index_phase(root: Path, mesh) -> float:
    """`ShardedIndex` over the 4.6 Mb reference's merged index on the
    two-shard mesh against the host merged-index walk, for the seeds of the
    first 4,096 150 bp reads.  Returns its values_memory_ratio."""
    import numpy as np

    from mapper_tpu_torch.batch.candidates import ReadBatch, collect_batch_seeds
    from mapper_tpu_torch.parallel.sharded_index import ShardedIndex
    from mapper_tpu_torch.sequence import Sequence

    db = load_database(root)
    lines = (root / "short.fastq").read_text().splitlines()[: 4 * DC_READS]
    batch = ReadBatch.from_sequences([Sequence.from_text(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)])
    _, _, _, num_bp, key, _ = collect_batch_seeds(batch, db)
    t0 = time.time()
    sharded = ShardedIndex(db, mesh, k_match=12)
    vals, counts, valid = sharded.lookup(num_bp, key)
    seconds = time.time() - t0
    merged = db.merged_index()
    bins = merged["bases"][num_bp] + np.remainder(key, merged["capacities"][num_bp])
    want_counts = merged["counts"][bins]
    take = np.minimum(want_counts, np.minimum(merged["caps"][num_bp], 12))
    j = np.arange(12)[None, :]
    want_valid = j < take[:, None]
    vidx = np.minimum(merged["offsets"][bins][:, None] + j, len(merged["values"]) - 1)
    want_vals = np.where(want_valid, merged["values"][vidx], 0)
    if not (np.array_equal(counts, want_counts) and np.array_equal(valid, want_valid)
            and np.array_equal(vals, want_vals)):
        raise AssertionError("ShardedIndex on two shards != the host merged-index walk")
    print(f"[sharded-index] {len(key)} seeds of {batch.num_reads} reads: positions, counts and valid equal "
          f"to the host walk ({int(valid.sum())} positions); values_memory_ratio "
          f"{sharded.values_memory_ratio:.6f}; built and looked up in {seconds:.2f} s", flush=True)
    return sharded.values_memory_ratio


def multi_process_phase(root: Path, one_process: dict) -> tuple[dict, dict]:
    """`python -m mapper_tpu_torch`'s CLI in two processes on the card
    (`--num-processes 2`), started together on the 100,000-read input,
    once with the file barrier and once with a gloo process group
    (`--coordinator`): all five outputs must be byte-identical to the
    one-process kernel-scored run.  Returns the processes' summed launch
    counts and each run's align phases."""
    import socket

    out_names = {"--out-sam": "out.sam", "--out-vcf": "out.vcf", "--out-mutations": "mutations.txt",
                 "--out-refs-map-count": "refs.txt", "--out-unaligned": "unaligned.fastq"}
    env = dict(os.environ, MAPPER_TPU_TORCH_DEVICE="cuda")
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent) + os.pathsep + env.get("PYTHONPATH", "")
    launches, align = {}, {}
    for barrier in ("files", "coordinator"):
        out = root / f"multi_process_{barrier}"
        out.mkdir()
        args = ["--reference", str(root / "ref.fasta"), "--queries", str(root / "short.fastq"),
                "--cache-dir", str(root / "index_cache"), "--num-processes", "2"]
        for flag, name in out_names.items():
            args += [flag, str(out / name)]
        if barrier == "coordinator":
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                args += ["--coordinator", f"127.0.0.1:{sock.getsockname()[1]}"]
        t0 = time.time()
        procs = [
            subprocess.Popen([sys.executable, "-c", MULTI_PROCESS_ENTRY, *args, "--process-id", str(k)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k in range(2)
        ]
        try:
            results = [p.communicate(timeout=MULTI_PROCESS_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        phases = []
        for k, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
            if p.returncode != 0:
                raise AssertionError(f"{barrier}: process {k} exited {p.returncode}\n{stderr[-3000:]}")
            for name, n in json.loads(stdout.strip().splitlines()[-1]).items():
                launches[name] = launches.get(name, 0) + n
            m = re.search(r"Align phase: (\d+) queries in ([0-9.]+)s", stderr)
            if m is None:
                raise AssertionError(f"{barrier}: process {k} logged no align phase\n{stderr[-3000:]}")
            phases.append({"queries": int(m.group(1)), "align_s": float(m.group(2))})
        for name in out_names.values():
            if (out / name).read_bytes() != (root / "short_kernel" / name).read_bytes():
                raise AssertionError(f"{barrier}: {name} of the 2-process run != the 1-process run")
        align[barrier] = {"processes": phases, "wall_s": wall,
                          "one_process_align_s": one_process["align_seconds"]}
        print(f"[multi-process] {barrier}: SAM, VCF, mutations, refs-map-count and unaligned byte-identical "
              f"to the 1-process run; align phases " + ", ".join(
                  f"process {k} {ph['queries']} queries in {ph['align_s']:.3f} s" for k, ph in enumerate(phases))
              + f" (1 process: {one_process['align_seconds']:.3f} s); both processes {wall:.1f} s", flush=True)
    if launches.get("banded_i16", 0) <= 0:
        raise AssertionError(f"the multi-process runs launched no banded_i16: {launches}")
    print(f"[multi-process] kernel launches in the four processes: {launches}", flush=True)
    return launches, align


def devices_beyond_the_card(root: Path) -> None:
    """`--devices 2` with one card visible is the JAX CLI's usage error:
    exit code 1, no run."""
    import torch

    from mapper_tpu_torch import cli

    if torch.cuda.device_count() != 1:
        print(f"[devices] {torch.cuda.device_count()} cards visible: the one-card usage error is not checked",
              flush=True)
        return
    log = io.StringIO()
    code = None
    with contextlib.redirect_stderr(log):
        try:
            cli.main(["--reference", str(root / "ref.fasta"), "--queries", str(root / "long.fastq"),
                      "--out-sam", str(root / "devices2.sam"), "--devices", "2"])
        except SystemExit as e:  # usage_error exits; anything else propagates
            code = e.code
    if code != 1 or "--devices 2 requested but only 1 visible" not in log.getvalue():
        raise AssertionError(f"--devices 2 on one card: exit {code}\n{log.getvalue()[-2000:]}")
    print("[devices] --devices 2 on one card: usage error, exit code 1", flush=True)


# ---- the entry points: graft_entry and the bench -------------------------

BENCH_TIMEOUT_S = 300
BENCH_LAUNCHES = re.compile(r"^\[bench\] kernel launches in the timed passes: (\{.*\})$", re.M)


def graft_entry_phase(kernels) -> tuple[dict, dict, dict]:
    """`graft_entry.entry()` on the card: its step launches banded_i16 (the
    block kernel, band 32) once and no other kernel, with the launch counts
    read around one call; its scores equal `banded_scores_reference` on the
    same arguments exactly (torch.equal); it is timed by CUDA events beside
    the int16 plain version on the card.  Then `dryrun_multichip(1)`, all
    five checks on the card, launch counts read around it.  Returns the
    step's and the dryrun's launch counts and the step's numbers."""
    import torch

    from mapper_tpu_torch import graft_entry
    from mapper_tpu_torch.align import banded
    from mapper_tpu_torch.align.params import AlignmentParameters

    step, args = graft_entry.entry()
    if any(a.device.type != "cuda" for a in args):
        raise AssertionError(f"entry(): arguments on {[str(a.device) for a in args]}")
    kernels.reset_launches()
    got = step(*args)
    torch.cuda.synchronize()
    step_launches = dict(kernels.LAUNCHES)
    print(f"[graft_entry] kernel launches of one step: {step_launches}", flush=True)
    if step_launches["banded_i16"] != 1 or sum(step_launches.values()) != 1:
        raise AssertionError(f"entry()'s step did not launch banded_i16 alone, once: {step_launches}")
    params = AlignmentParameters.defaults()
    want = banded.banded_scores_reference(*(a.cpu() for a in args), params, graft_entry.BAND)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"entry()'s step != banded_scores_reference: max error {(got.cpu() - want).abs().max()}")
    # the int16 route's plain version on the card, on the rows the step pads
    q, w, n, m = banded._host_rows(*args, graft_entry.BAND, banded.DEFAULT_CHUNK)
    scale, units = banded._quantize_params(params, q.shape[1], graft_entry.BAND)

    def plain():
        return banded._from_units(*banded._pen_core_i16(q.to(torch.int32), w.to(torch.int32), n, m, units,
                                                         graft_entry.BAND), scale)[0]

    if not torch.equal(plain(), got):
        raise AssertionError("entry()'s step != its plain version on the card")
    ms = cuda_ms(lambda: step(*args), 20)
    plain_ms = cuda_ms(plain, 3)
    cells = cells_of(args[2], q.shape[1], graft_entry.BAND)
    bound_ms, bound_by = bound(cells, "i16", nbytes(*args, got))
    numbers = {"scores": list(got.shape), "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "launches": step_launches["banded_i16"]}
    print(f"[graft_entry] entry(): {len(got)} scores equal to banded_scores_reference; step {ms:.4f} ms "
          f"(CUDA events), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})", flush=True)

    kernels.reset_launches()
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        graft_entry.dryrun_multichip(1)
    dryrun_launches = dict(kernels.LAUNCHES)
    summary = out.getvalue().strip().splitlines()[-1]
    print(f"[dryrun] {summary} ({time.time() - t0:.1f} s); kernel launches: {dryrun_launches}", flush=True)
    if not summary.startswith("dryrun_multichip(1): ok on cuda"):
        raise AssertionError(f"dryrun_multichip(1): {summary}")
    if dryrun_launches["banded_i16"] <= 0:
        raise AssertionError(f"dryrun_multichip(1) launched no banded_i16: {dryrun_launches}")
    return step_launches, dryrun_launches, numbers


def bench_run() -> tuple[dict, dict]:
    """`python -m mapper_tpu_torch.bench` as a subprocess on
    MAPPER_TPU_TORCH_DEVICE (`main` sets `cuda`), with the engine's default
    settings.  Returns its JSON line and its timed passes' launches."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "mapper_tpu_torch.bench"], env=env, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    found = BENCH_LAUNCHES.search(proc.stderr)
    if found is None:
        raise AssertionError(f"bench printed no launch counts:\n{proc.stderr[-3000:]}")
    return line, json.loads(found.group(1))


def bench_phase() -> tuple[dict, list]:
    """The bench twice, one run after the other.  Each run's JSON line is
    printed; each must align at least 99% of its reads.  Returns the runs'
    launches, summed, and the runs in order."""
    launches, runs = {}, []
    for _ in range(2):
        line, counts = bench_run()
        print(json.dumps(line), flush=True)
        detail = line["detail"]
        if detail["package"] != "mapper_tpu_torch":
            raise AssertionError(f"bench: detail {detail}")
        if detail["aligned_fraction"] < 0.99:
            raise AssertionError(f"bench: aligned fraction {detail['aligned_fraction']} < 0.99")
        passes = len(detail["pass_seconds"])
        for name, k in counts.items():
            launches[name] = launches.get(name, 0) + k
        print(f"[bench] {line['value']:.1f} reads/s (median "
              f"{detail['median_reads_per_second']:.1f}), banded_i16 {counts['banded_i16']} launches in {passes} "
              f"passes, banded_f32 {counts['banded_f32']}", flush=True)
        runs.append({"reads_per_second": line["value"],
                     "median_reads_per_second": detail["median_reads_per_second"],
                     "banded_i16": counts["banded_i16"], "banded_f32": counts["banded_f32"], "passes": passes})
    return launches, runs


def _dp_rate(dp_type: str) -> dict:
    """The operation count and rate a DP kernel's bound used."""
    ops_per_cell, ops_per_s = DP_RATES[dp_type]
    return {"bound_ops_per_cell": ops_per_cell, "bound_ops_per_s": ops_per_s}


def kernel_entries(i16, f32, host_rows, host_extra, probe_rows, dc_numbers, by_path) -> list[dict]:
    """The `kernels` line: one entry per kernel with its own path's launches
    ("launches", the CLI for the engine's kernels, the host-window path for
    K3-K5, the probe entry for P1-P9, the fused CLI runs for KC1 and KC2),
    its launches in the main path, the
    100,000-read single-end CLI run ("launches_main_path"), each path's count
    read around that path alone ("launches_by_path"), and its times, bound and
    yardstick.  Raises if a kernel has no launch on its own path."""
    from mapper_tpu_torch.probe_i16.probes import SITES

    # name -> (source, replaces, path, max |error|, ms, plain ms, bound ms,
    # what bounds it, library ms, extra keys)
    none = "no single PyTorch call computes a banded affine-gap DP"
    rows = {
        # i16 at band 64: the band 150 bp reads take at default penalties
        "banded_i16": (KERNEL_SOURCE, REPLACES["banded_i16"], "cli", max(r[0] for r in i16),
                       *i16[0][1:], None, {"library": none, **_dp_rate("i16"), "by_band": {
                           band: {"ms": r[1], "plain_ms": r[2], "bound_ms": r[3]}
                           for band, r in zip((64, 128), i16)}}),
        # f32's row at band 128, the shape of its earlier rows; the engine
        # picks band 64 or 128 by a batch's largest indel budget
        "banded_f32": (KERNEL_SOURCE, REPLACES["banded_f32"], "cli", max(r[0] for r in f32),
                       *f32[1][1:], None, {"library": none, **_dp_rate("f32"), "by_band": {
                           band: {"ms": r[1], "plain_ms": r[2], "bound_ms": r[3]}
                           for band, r in zip((64, 128), f32)}}),
        **{name: (KERNEL_SOURCE, REPLACES[name], "host_window", *host_rows[name], None,
                  {"library": none, **_dp_rate("i16" if name == "banded_i16_packed" else "f32"),
                   **host_extra[name]})
           for name in ("banded_i16_packed", "banded_roll_f32", "banded_chunk_f32")},
        **{f"probe_i16_{stage}": (PROBE_SOURCE, site, "probe_i16", *probe_rows[stage][:3], probe_rows[stage][3],
                                  "bytes", probe_rows[stage][4], {
                                      "library": f"sum over the {probe_rows[stage][5]} of "
                                                 f"{len(probe_rows[stage][6])} bodies with one PyTorch call",
                                      "bodies": probe_rows[stage][6]})
           for stage, site in SITES.items()},
        # KC1 and KC2 at the 150 bp chunk, the CLI's; every workload in by_workload
        **{name: (DC_SOURCE, DC_REPLACES[name], "device_candidates", dc_numbers["150bp"][name]["max_abs_err"],
                  *(dc_numbers["150bp"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")), None,
                  {"library": "no PyTorch call computes the pyramid, the vote or the kept rows' geometry",
                   "wall_ms": dc_numbers["150bp"][name]["wall_ms"],
                   "by_workload": {tag: {k: w[name][k] for k in ("ms", "events_ms", "wall_ms", "plain_ms", "bound_ms",
                                                                 "bound_by", "share", "max_abs_err")}
                                   for tag, w in dc_numbers.items()}})
           for name in ("candidates", "fused_rows")},
    }
    entries = []
    for name, (source, replaces, path, err, ms, plain_ms, bound_ms, bound_by, library_ms, extra) in rows.items():
        entries.append({
            **extra,  # first: no extra key replaces one of the line's own
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": path, "launches": by_path[path][name],
            "launches_main_path": by_path["main_path"][name],
            "launches_by_path": {p: counts.get(name, 0) for p, counts in by_path.items()},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            # probes: one CUDA-graph replay of 20 calls; the rest: 20 calls
            # (KC1 and KC2 10) issued from Python
            "timing": "cuda_graph_replay" if path == "probe_i16" else "cuda_events",
        })
    for entry in entries:
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} has no launches on its path {entry['path']}")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mapper_tpu_torch.align.params import AlignmentParameters
    from mapper_tpu_torch.align import kernels

    device = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"[gpu] {gpu}", flush=True)
    t0 = time.time()
    kernels.library()
    print(f"[build] kernels built in {time.time() - t0:.2f} s", flush=True)
    # the host's native C++ libraries build at first use as well: build them
    # here so no timed run pays for it
    from mapper_tpu_torch import native

    t0 = time.time()
    for get in (native.get_library, native.get_candidates_library,
                native.get_textrows_library, native.get_counting_library):
        if get() is None:
            raise RuntimeError(f"native host library unavailable: {get.__name__}")
    print(f"[build] native host libraries ready in {time.time() - t0:.2f} s", flush=True)

    params = AlignmentParameters.defaults()
    i16 = [compare_kernel("banded_i16", 192, band, 16384, params, band, device) for band in (64, 128)]
    f32 = [compare_kernel("banded_f32", 1024, band, 4096, params, 7, device) for band in (64, 128)]
    inputs = host_window_inputs(device)
    host_rows, host_extra, f32_plain = compare_host_row_kernels(params, inputs)
    probe_rows = compare_probes(device)
    probe_launches = probe_phase(kernels)
    window_launches = host_window_phase(params, inputs, kernels, f32_plain)
    # the parallel slice's mesh: two shards on the one card
    from mapper_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([device, device])
    sharded_launches = sharded_scores_phase(params, inputs, kernels, mesh)
    del inputs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        simulate_inputs(root, 4_600_000, 100_000, 2_000, 20_000, 500)
        print(f"[data] simulated in {time.time() - t0:.1f} s", flush=True)
        os.environ["MAPPER_TPU_TORCH_DEVICE"] = "cuda"
        main_launches, cli_launches, runs = cli_phase(root, kernels)
        pileup_launches = device_pileup_phase(root, kernels, runs["short_kernel"])
        programs = device_candidates_programs(root, params, device)
        fused = device_candidates_phase(root, kernels, runs)
        paired_launches, _ = twin_phase(root, kernels, PAIRED, "paired", "banded_i16")
        # pairs take the paired path on the fused setting too, as in the JAX
        # engine: phase 7's paired_mates chunk holds KC1 and KC2 at their shape
        split_launches, split_twin = twin_phase(root, kernels, SPLIT, "split_queries", "banded_f32")
        _, split_fused = fused_run(root, kernels, SPLIT, "split_queries_fused", split_twin)
        t0 = time.time()
        simulate_config4(root / "config4")
        simulate_config5(root / "config5")
        print(f"[data] configs 4 and 5 simulated in {time.time() - t0:.1f} s", flush=True)
        config4_launches, _ = twin_phase(root / "config4", kernels, CONFIG4, "config4", "banded_i16",
                                         CONFIG4_OUTPUTS)
        config5_launches, _ = twin_phase(root / "config5", kernels, CONFIG5, "config5", "banded_f32",
                                         CONFIG5_OUTPUTS)
        mesh_launches, mesh_times = mesh_engine_phase(root, params, kernels, mesh)
        values_ratio = sharded_index_phase(root, mesh)
        multi_launches, multi_align = multi_process_phase(root, runs["short_kernel"])
        devices_beyond_the_card(root)
    entry_launches, dryrun_launches, entry_numbers = graft_entry_phase(kernels)
    bench_launches, bench_runs = bench_phase()

    print(json.dumps({"device_candidates": {**programs, "cli": fused["align"], "gpu": gpu}}))
    print(json.dumps({"parallel": {"mesh": str(mesh), "mesh_engine": mesh_times,
                                   "sharded_index_values_memory_ratio": values_ratio,
                                   "multi_process": multi_align, "gpu": gpu}}))
    print(json.dumps({"entry_points": {"graft_entry": entry_numbers, "dryrun_launches": dryrun_launches,
                                       "bench": bench_runs, "gpu": gpu}}))
    by_path = {
        "main_path": main_launches, "cli": cli_launches, "host_window": window_launches,
        "probe_i16": probe_launches, "device_pileup": pileup_launches,
        "device_candidates": fused["launches"], "paired": paired_launches, "split_queries": split_launches,
        "split_queries_fused": split_fused,
        "mesh": mesh_launches, "multi_process": multi_launches, "sharded_scores": sharded_launches,
        "config4": config4_launches, "config5": config5_launches,
        "graft_entry": entry_launches, "dryrun": dryrun_launches, "bench": bench_launches,
    }
    entries = kernel_entries(i16, f32, host_rows, host_extra, probe_rows, programs["kernels"], by_path)
    print(json.dumps({"kernels": entries}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
