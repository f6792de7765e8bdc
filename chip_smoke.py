"""Smoke run of mapper_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
1. print the card's name and power limit, build the CUDA kernels from
   `mapper_tpu_torch/align/csrc/banded_dp.cu` and print the build time;
2. compare each kernel with its plain PyTorch version on the card at the
   main paths' shapes and time both with CUDA events: banded_i16 at read
   width 192, bands 64 and 128, 16,384 candidates, exact equality;
   banded_f32 at width 1024, band 128, 4,096 candidates, within 1e-5;
   banded_i16_packed on the host-window rows of width 192 (256 padded) at
   band 64, exact; banded_roll_f32 and banded_chunk_f32 (chunk 128) on the
   rows of width 1024 at band 128, within 1e-5;
3. the host-window path: `banded_scores` on rows gathered on the card
   (`banded._gather_codes`) from candidates over a 4.6 Mb reference, with
   the launch counts read around it: "pen" at width 192 (band 64 through
   banded_i16_packed, band 128 through banded_i16) and 1024 (band 128, f32),
   "roll" and "chunk" at width 1024.  All five kernels must launch; "pen"
   scores and diagonal sums at each lane must equal `banded_scores_gathered`
   on the same candidates exactly, the packed band-64 run must equal
   banded_i16 on the same rows exactly, and "roll", "chunk" and "pen" must
   give the same f32 scores bit for bit;
4. run the CLI (`mapper_tpu_torch.cli.main`) on a simulated 4.6 Mb
   reference, the size of E. coli K-12: 100,000 single-end 150 bp reads
   (1% SNPs, a 1-3 bp indel in 10% of reads, half reverse-complemented) and
   2,000 reads of 1,000 bp in a second run, each with --out-sam --out-vcf
   --out-refs-map-count --out-unaligned.  Both kernels must launch, at least
   99% of reads must align, and SAM and VCF must be byte-identical to the
   same runs scored by the exact native DP on the host
   (MAPPER_TPU_HOST_SCORING=1, with the ceiling raised to 1,024 bp so the
   long reads are host-scored too), which must launch no kernel.

The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a card, and without
the rest of the repository beside this file.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the port runs without JAX: any import of it fails from here on
sys.modules["jax"] = None
# the host-scored twins score every read on the host, the 1,000 bp ones too
# (the engine reads this ceiling when it is imported; it defaults to 600 bp)
os.environ["MAPPER_TPU_HOST_SCORING_MAX_LEN"] = "1024"
sys.path.insert(0, str(Path(__file__).resolve().parent))

KERNEL_SOURCE = "mapper_tpu_torch/align/csrc/banded_dp.cu"
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
HOST_WINDOW_SHAPES = {(192, 64): (16384, 64), (192, 128): (16384, 128), (1024, 128): (4096, 7)}


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


def compare_kernel(name, lq, band, num_cands, params, seed, device):
    """Kernel vs plain version on the card: (max |difference|, kernel ms,
    plain ms); prints the kernel's Gcells/s beside them."""
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
    if name == "banded_i16" and not torch.equal(got, want):
        raise AssertionError(f"{name} band {band}: kernel != plain (max error {err})")
    if not err <= 1e-5:
        raise AssertionError(f"{name} band {band}: max error {err} > 1e-5")
    finite = float((got[0] < 1e8).float().mean())
    if finite < 0.5:
        raise AssertionError(f"{name}: only {finite:.2f} of the rows scored")
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    _report(name, f"lq={lq} band={band} B={num_cands}", err, ms, plain_ms, float(cands["n"].sum()) * band)
    return err, ms, plain_ms


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


def _report(name, shape, err, ms, plain_ms, cells):
    print(
        f"[kernel] {name} {shape}: max_abs_err={err} kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {cells / ms / 1e6:.2f} Gcells/s",
        flush=True,
    )


def compare_host_row_kernels(params, inputs) -> dict:
    """K3, K4 and K5 against their plain versions on the card, at the
    host-window path's shapes: {name: (max |difference|, kernel ms, plain ms)}."""
    import torch

    from mapper_tpu_torch.align import banded, kernels

    results = {}
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
    results["banded_i16_packed"] = (err, cuda_ms(packed, 20), cuda_ms(packed_plain, 2))
    _report("banded_i16_packed", f"lq={q.shape[1]} band=64 B={q.shape[0]}", *results["banded_i16_packed"],
            float(n.sum()) * 64)

    # band 64 on the same candidates, timed in turns (A B C C B A): banded_i16
    # on the gathered path, banded_i16 on the host rows, banded_i16_packed
    args = inputs[(192, 64)][0]
    rows = banded._rows_as_candidates(q, w, n, m)
    turns = {
        "banded_i16 gathered": lambda: kernels.banded_i16(*args, ints, banded._inv(scale), 64),
        "banded_i16 host rows": lambda: kernels.banded_i16(*rows, ints, banded._inv(scale), 64),
        "banded_i16_packed host rows": packed,
    }
    times = {name: [] for name in turns}
    for name in [*turns, *reversed(turns)]:
        times[name].append(cuda_ms(turns[name], 20))
    print(f"[kernel] band 64, same {q.shape[0]} candidates, in turns: " + ", ".join(
        f"{name} {sum(t) / len(t):.4f} ms" for name, t in times.items()
    ), flush=True)

    q, w, n, m = inputs[(1024, 128)][1]
    if banded._quantize_params(params, q.shape[1], 128) is not None:
        raise AssertionError("the host-window f32 rows quantize at width 1024")
    params6 = banded._params_tuple(params)
    qi, wi = q.to(torch.int32), w.to(torch.int32)

    def f32_plain():
        return banded._pen_core(qi, wi, n, m, params6, 128)[0]

    want = f32_plain()
    plain_ms = cuda_ms(f32_plain, 1)  # K4's and K5's plain version is one function
    for name, kernel in (
        ("banded_roll_f32", lambda: kernels.banded_roll_f32(q, w, n, m, params6, 128)),
        ("banded_chunk_f32", lambda: kernels.banded_chunk_f32(q, w, n, m, params6, 128, CHUNK)),
    ):
        got = kernel()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"{name}: max error {err} > 1e-5")
        if float((got < 1e8).float().mean()) < 0.5:
            raise AssertionError(f"{name}: fewer than half of the rows scored")
        results[name] = (err, cuda_ms(kernel, 20), plain_ms)
        _report(name, f"lq={q.shape[1]} band=128 B={q.shape[0]}", *results[name], float(n.sum()) * 128)
    return results


def host_window_phase(params, inputs, kernels) -> dict:
    """The host-window path, `banded_scores` in every variant, with the
    launch counts set to 0 just before it and read just after; then its
    checks.  Returns the launch counts."""
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
    for name, count in launches.items():
        if count <= 0:
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
    if not (torch.equal(roll, chunk) and torch.equal(chunk, pen[(1024, 128)][0])):
        raise AssertionError("roll, chunk and pen f32 scores differ at width 1024")
    print("[host-window] lq=1024 band=128: roll == chunk == pen f32, bit for bit", flush=True)
    return launches


def simulate_inputs(root: Path, ref_size: int, num_short: int, num_long: int, seed: int = 0):
    import numpy as np

    from benchmarks.simlib import random_reference, write_reference
    from mapper_tpu_torch.simulate import simulate_reads, write_fastq

    rng = np.random.default_rng(seed)
    ref = random_reference(rng, ref_size)
    write_reference(str(root / "ref.fasta"), {"chr1": ref})
    write_fastq(root / "short.fastq", simulate_reads(rng, ref, num_short, 150, 0.01, 0.1, "s"))
    write_fastq(root / "long.fastq", simulate_reads(rng, ref, num_long, 1000, 0.01, 0.1, "l"))


def run_cli(root: Path, queries: str, tag: str, host_scoring: bool) -> dict:
    """One CLI run; returns its output bytes and align-phase numbers."""
    from mapper_tpu_torch import cli

    out = root / tag
    out.mkdir()
    args = [
        "--reference", str(root / "ref.fasta"), "--queries", str(root / queries),
        "--out-sam", str(out / "out.sam"), "--out-vcf", str(out / "out.vcf"),
        "--out-refs-map-count", str(out / "refs.txt"),
        "--out-unaligned", str(out / "unaligned.fastq"),
        "--cache-dir", str(root / "index_cache"),
    ]
    env_before = os.environ.get("MAPPER_TPU_HOST_SCORING")
    if host_scoring:
        os.environ["MAPPER_TPU_HOST_SCORING"] = "1"
    else:
        os.environ.pop("MAPPER_TPU_HOST_SCORING", None)
    log = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stderr(log):
            rc = cli.main(args)
    finally:
        if env_before is None:
            os.environ.pop("MAPPER_TPU_HOST_SCORING", None)
        else:
            os.environ["MAPPER_TPU_HOST_SCORING"] = env_before
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"{tag}: CLI returned {rc}\n{log.getvalue()[-3000:]}")
    m = re.search(r"Align phase: (\d+) queries in ([0-9.]+)s", log.getvalue())
    if m is None:
        raise AssertionError(f"{tag}: no align-phase line\n{log.getvalue()[-3000:]}")
    num, seconds = int(m.group(1)), float(m.group(2))
    unaligned = (out / "unaligned.fastq").read_text().count("\n") // 4
    result = {
        "sam": (out / "out.sam").read_bytes(),
        "vcf": (out / "out.vcf").read_bytes(),
        "queries": num,
        "aligned_fraction": 1.0 - unaligned / num,
        "align_seconds": seconds,
        "wall_seconds": wall,
    }
    print(
        f"[cli] {tag}: {num} queries, aligned {result['aligned_fraction']:.4f}, "
        f"align phase {seconds:.3f} s = {num / seconds:.1f} reads/s, run {wall:.1f} s",
        flush=True,
    )
    return result


def cli_phase(root: Path, kernels) -> dict:
    """The main path: kernel-scored CLI runs (launches counted) and their
    host-scored twins (which launch nothing); returns the launch counts of
    the kernel runs."""
    kernels.reset_launches()
    short = run_cli(root, "short.fastq", "short_kernel", host_scoring=False)
    long_ = run_cli(root, "long.fastq", "long_kernel", host_scoring=False)
    launches = dict(kernels.LAUNCHES)
    print(f"[cli] kernel launches in the main path: {launches}", flush=True)
    for name in ("banded_i16", "banded_f32"):  # the engine's gathered scorer
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    for run in (short, long_):
        if run["aligned_fraction"] < 0.99:
            raise AssertionError(f"aligned fraction {run['aligned_fraction']} < 0.99")
    kernels.reset_launches()
    short_host = run_cli(root, "short.fastq", "short_host", host_scoring=True)
    long_host = run_cli(root, "long.fastq", "long_host", host_scoring=True)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the host-scored runs launched kernels: {kernels.LAUNCHES}")
    print("[cli] host-scored runs launched no kernel", flush=True)
    for kernel_run, host_run, tag in ((short, short_host, "short"), (long_, long_host, "long")):
        for out in ("sam", "vcf"):
            if kernel_run[out] != host_run[out]:
                raise AssertionError(f"{tag}: {out.upper()} differs from the host-scored run")
        print(f"[cli] {tag}: SAM and VCF byte-identical to the host-scored run", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mapper_tpu.align.params import AlignmentParameters
    from mapper_tpu_torch.align import kernels

    device = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"[gpu] {gpu}", flush=True)
    t0 = time.time()
    kernels.library()
    print(f"[build] kernels built in {time.time() - t0:.2f} s", flush=True)
    # the host's native C++ libraries build at first use as well: build them
    # here so no timed run pays for it
    from mapper_tpu import native

    t0 = time.time()
    for get in (native.get_library, native.get_candidates_library,
                native.get_textrows_library, native.get_counting_library):
        if get() is None:
            raise RuntimeError(f"native host library unavailable: {get.__name__}")
    print(f"[build] native host libraries ready in {time.time() - t0:.2f} s", flush=True)

    params = AlignmentParameters.defaults()
    i16 = [compare_kernel("banded_i16", 192, band, 16384, params, band, device) for band in (64, 128)]
    f32 = compare_kernel("banded_f32", 1024, 128, 4096, params, 7, device)
    inputs = host_window_inputs(device)
    host_rows = compare_host_row_kernels(params, inputs)
    window_launches = host_window_phase(params, inputs, kernels)
    del inputs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        simulate_inputs(root, 4_600_000, 100_000, 2_000)
        print(f"[data] simulated in {time.time() - t0:.1f} s", flush=True)
        os.environ["MAPPER_TPU_TORCH_DEVICE"] = "cuda"
        cli_launches = cli_phase(root, kernels)

    rows = [
        # i16 at band 64: the band 150 bp reads take at default penalties
        ("banded_i16", max(e for e, _, _ in i16), i16[0][1], i16[0][2]),
        ("banded_f32", f32[0], f32[1], f32[2]),
        *((name, *host_rows[name]) for name in ("banded_i16_packed", "banded_roll_f32", "banded_chunk_f32")),
    ]
    # "launches" is the count of the kernel's own path ("path"): the CLI for
    # the engine's kernels, the host-window path for the rest; each path's
    # count, read around that path alone, is under "launches_by_path"
    by_path = {"cli": cli_launches, "host_window": window_launches}
    entries = []
    for name, err, ms, plain_ms in rows:
        path = "cli" if name in cli_launches and cli_launches[name] > 0 else "host_window"
        entries.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "path": path, "launches": by_path[path][name],
            "launches_by_path": {p: counts.get(name, 0) for p, counts in by_path.items()},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": entries}))
    print(gpu)
    # the run drove one card, whatever else the host has
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
