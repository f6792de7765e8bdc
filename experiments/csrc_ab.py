"""Two builds of `mapper_tpu_torch/align/csrc/` side by side on one card:
which kernels compile to the same SASS, and the times of the kernels both
builds share, in turns (A B B A), each build's output held equal to the
plain version first.

    python3 experiments/csrc_ab.py [--candidates-only] A_CSRC B_CSRC

A_CSRC and B_CSRC are source directories laid out as `csrc/` (for example
the parent commit's, unpacked with `git archive` into a directory that
.gitignore lists).  First the device-candidates kernels: each tree's KC1
and KC2 registers, spills and stack (`experiments/ptxas_report.py`), and on
`chip_smoke.py`'s phase 7 chunks (150 bp, 1,000 bp, the paired mates, one
5,000 bp read; `experiments/dc_chunks.py`) each tree's KC1 and KC2 output
held equal to the plain version (torch.equal), then both timed in turns (A
B B A, CUDA-graph replay of 20 calls a reading, so that the host's pace of
issuing calls is not in the time; KC2 on the plain table, its status words
zeroed in each call where the tree takes them) with B's shared
memory a block, and each tree's SASS instruction mix of both kernels.
`--candidates-only` stops there.  Timed (CUDA events, 20 calls): banded_i16 (K1) at
[16384, 192], bands 32, 64 and 128; banded_i16_packed (K3) on those
candidates' band-64 rows; banded_f32 (K2) at 4,096 x 1024, bands 32, 64 and
128; banded_roll_f32 (K5) and banded_chunk_f32 (K4, chunk 128) on those
candidates' rows at bands 32, 64 and 128 (band 32 takes the block kernels);
and (CUDA-graph replay of 50 calls) the 40 probe bodies at [16384, 128].
Also prints the SASS instruction mix of the x loop (the innermost loop with
SHFL.UP) of B's warp kernels of K1, K3 and K4/K5.  Needs a card and nvcc;
builds under `mapper_tpu_torch/_build/`.
"""
import re
import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np
import torch
from mapper_tpu_torch.align import banded, kernels
from mapper_tpu_torch.align.params import AlignmentParameters
from mapper_tpu_torch.probe_i16 import probes
from mapper_tpu_torch.simulate import scoring_candidates
import chip_smoke as cs
from experiments import sass_loops

args = [a for a in sys.argv[1:] if a != "--candidates-only"]
dirs = {"A": Path(args[0]).resolve(), "B": Path(args[1]).resolve()}
libs = {key: kernels.library(build_dir=kernels.BUILD_DIR / f"ab_{key}", csrc=d) for key, d in dirs.items()}
print(cs.gpu_line())


def candidates_ab() -> None:
    """KC1 and KC2 of both trees on phase 7's chunks: equal to the plain
    versions, then timed in turns."""
    import tempfile

    from experiments import dc_chunks
    from experiments.ptxas_report import report
    from mapper_tpu_torch.batch import device_candidates as dc

    for key, d in dirs.items():
        for line in report(d, "", ("candidates.cu",)):
            print(f"{key} ptxas {line}", flush=True)
        for name, part in sass_loops.functions(libs[key]._name).items():
            if "candidates_kernel" in name or "fused_rows_kernel" in name:
                mix = sass_loops.instruction_mix(part)
                print(f"{key} SASS {name}: {sass_loops.mix_line(mix)[:400]}", flush=True)
    with tempfile.TemporaryDirectory(prefix="ab_chunks_") as tmp:
        for tag, (inputs, band) in dc_chunks.phase7_chunks(Path(tmp)).items():
            want = dc.candidates_plain(inputs)
            plain_rows = dc.fused_rows_plain(want, inputs, band)
            calls = {"candidates": {}, "fused_rows": {}}
            for key, lib in libs.items():
                kc1, out = dc_chunks.kc1_call(lib, inputs)
                table = want.clone()
                kc2, rows = dc_chunks.kc2_call(lib, dirs[key], table, inputs, band)
                if kc1() != 0 or kc2() != 0:
                    raise RuntimeError(f"{key}: launch failed on {tag}")
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{key} KC1 != plain on {tag}: {int((out != want).any(dim=1).sum())} reads")
                for got, ref in zip((table, *rows), plain_rows):
                    if got.dtype != ref.dtype or not torch.equal(got, ref):
                        raise AssertionError(f"{key} KC2 != plain on {tag}")
                calls["candidates"][key], calls["fused_rows"][key] = kc1, kc2
            width = int(inputs["codes"].shape[1])
            smem = {"candidates": kernels.smem_bytes("candidates", width), "fused_rows": kernels.smem_bytes("fused_rows", width)}
            for name, fns in calls.items():
                times = {"A": [], "B": []}
                for key in ("A", "B", "B", "A"):
                    times[key].append(cs.graph_ms(fns[key], 20))
                a, b = np.mean(times["A"]), np.mean(times["B"])
                print(f"[dc] {tag} {name}: equal to plain in both; A {a:.4f} ms ({', '.join(f'{t:.4f}' for t in times['A'])}), "
                      f"B {b:.4f} ms ({', '.join(f'{t:.4f}' for t in times['B'])}), B/A {b / a:.3f}; "
                      f"B shared memory {smem[name]} bytes a block", flush=True)


candidates_ab()
if "--candidates-only" in sys.argv:
    sys.exit(0)

# SASS, function by function
raw = {key: sass_loops.functions(lib._name) for key, lib in libs.items()}
sass = {}
for key, parts in raw.items():
    # a kernel in an anonymous namespace, and the symbols it refers to, carry
    # a hash of their file in their names: every run of 8 or more hex digits
    # is left out (the instructions' encodings with them, not their text),
    # and so is the column padding, which follows the longest line
    sass[key] = {}
    for part in parts.values():
        part = "\n".join(" ".join(line.split()) for line in re.sub(r"[0-9a-f]{8,}", "#", part).splitlines())
        sass[key][part.splitlines()[0]] = part
common = sorted(set(sass["A"]) & set(sass["B"]))
differ = [name for name in common if sass["A"][name] != sass["B"][name]]
print(f"SASS: {len(common)} kernels in both builds, {len(common) - len(differ)} identical; "
      f"only in A: {len(set(sass['A']) - set(common))}, only in B: {len(set(sass['B']) - set(common))}")
for name in differ:
    a, b = sass["A"][name].splitlines(), sass["B"][name].splitlines()
    pairs = [(x, y) for x, y in zip(a, b) if x != y]
    print(f"  differs: {name}: {len(a)} against {len(b)} lines, {len(pairs)} of the paired lines differ; first:")
    for x, y in pairs[:2]:
        print(f"    A {x[:120]}\n    B {y[:120]}")


for name, part in raw["B"].items():
    if any(k in name for k in ("banded_i16_warp_kernel", "banded_i16_packed_warp_kernel",
                               "banded_chunk_f32_warp_kernel")):
        mix = sass_loops.shuffle_loops(part)[0][0]
        print(f"B x loop SASS of {name}: {sass_loops.mix_line(mix)}", flush=True)

params = AlignmentParameters.defaults()


def stream():
    """The current stream when a call runs (a graph captures on its own)."""
    return torch.cuda.current_stream().cuda_stream


p6 = banded._params_tuple(params)
calls = {}  # name -> {key: (fn, output, plain output)}, timed with `timers[name]`
timers = {}
alive = []  # the tensors whose addresses the calls hold
for band in (32, 64, 128):
    cands = scoring_candidates(np.random.default_rng(band), 16384, 192, band, ref_size=4_600_000, num_reads=4096)
    args = banded._normalize(*[torch.as_tensor(cands[k]).cuda() for k in cs._KEYS])
    scale, ints = banded._quantize_params(params, 192, band)
    want = banded._gathered_core(*args, params, band)
    reads, concat, read_id, rev, ws, lane, n, m = args
    alive.append(args)
    ptrs = [reads.data_ptr(), 192, concat.data_ptr(), concat.shape[0], read_id.data_ptr(), rev.data_ptr(),
            ws.data_ptr(), lane.data_ptr(), n.data_ptr(), m.data_ptr(), 16384, band]
    outs = {key: torch.empty((2, 16384), dtype=torch.float32, device="cuda") for key in libs}
    calls[f"banded_i16 band {band}"] = {
        key: (lambda lib=lib, out=outs[key], ptrs=ptrs, ints=ints, inv=banded._inv(scale): lib.mapper_banded_i16(
            *ptrs, *ints, inv, out.data_ptr(), None, stream()), outs[key], want) for key, lib in libs.items()}
    timers[f"banded_i16 band {band}"] = lambda fn: cs.cuda_ms(fn, 20)
    if band == 64:
        qg, wg = banded._gather_codes(reads, concat, read_id, rev, ws, n, 64)
        q3, w3, n64, m64 = banded._host_rows(qg, wg, n, m, 64, cs.CHUNK)
        scale64, ints64 = banded._quantize_params(params, q3.shape[1], 64)
        want3 = banded._from_units(
            *banded._pen_core_i16(q3.to(torch.int32), w3.to(torch.int32), n64, m64, ints64, 64), scale64)[0]
        outs3 = {key: (torch.empty(16384, device="cuda"), torch.empty((16384, 64), device="cuda")) for key in libs}
        calls["banded_i16_packed"] = {
            key: (lambda lib=lib, o=outs3[key]: lib.mapper_banded_i16_packed(
                q3.data_ptr(), q3.shape[1], w3.data_ptr(), w3.shape[1], n64.data_ptr(), m64.data_ptr(), 16384,
                *ints64, banded._inv(scale64), o[0].data_ptr(), o[1].data_ptr(), stream()), outs3[key][0], want3)
            for key, lib in libs.items()}
        timers["banded_i16_packed"] = lambda fn: cs.cuda_ms(fn, 20)
for band in (32, 64, 128):
    cands = scoring_candidates(np.random.default_rng(7), 4096, 1024, band, ref_size=4_600_000, num_reads=4096)
    args = banded._normalize(*[torch.as_tensor(cands[k]).cuda() for k in cs._KEYS])
    alive.append(args)
    want = banded._gathered_core(*args, params, band)
    reads, concat, read_id, rev, ws, lane, n, m = args
    ptrs = [reads.data_ptr(), 1024, concat.data_ptr(), concat.shape[0], read_id.data_ptr(), rev.data_ptr(),
            ws.data_ptr(), lane.data_ptr(), n.data_ptr(), m.data_ptr(), 4096, band]
    outs = {key: torch.empty((2, 4096), dtype=torch.float32, device="cuda") for key in libs}
    calls[f"banded_f32 band {band}"] = {
        key: (lambda lib=lib, out=outs[key], ptrs=ptrs: lib.mapper_banded_f32(
            *ptrs, *p6, out.data_ptr(), None, stream()), outs[key], want) for key, lib in libs.items()}
    timers[f"banded_f32 band {band}"] = lambda fn: cs.cuda_ms(fn, 20)
    qg, wg = banded._gather_codes(reads, concat, read_id, rev, ws, n, band)
    q5, w5, n5, m5 = banded._host_rows(qg, wg, n, m, band, cs.CHUNK)
    alive.append((q5, w5, n5, m5))
    want5 = banded._pen_core(q5.to(torch.int32), w5.to(torch.int32), n5, m5, p6, band)[0]
    rows = [q5.data_ptr(), q5.shape[1], w5.data_ptr(), w5.shape[1], n5.data_ptr(), m5.data_ptr(), 4096, band]
    for name, extra in (("banded_roll_f32", ()), ("banded_chunk_f32", (cs.CHUNK,))):
        outs5 = {key: torch.empty(4096, device="cuda") for key in libs}
        calls[f"{name} band {band}"] = {
            key: (lambda fn=getattr(lib, f"mapper_{name}"), o=outs5[key], rows=rows, extra=extra: fn(
                *rows, *extra, *p6, o.data_ptr(), stream()), outs5[key], want5) for key, lib in libs.items()}
        timers[f"{name} band {band}"] = lambda fn: cs.cuda_ms(fn, 20)
x = torch.from_numpy(np.random.default_rng(0).integers(-2**15, 2**15, (16384, probes.B)).astype(np.int16)).cuda()
for stage, bodies in probes.STAGES.items():
    for i, body in enumerate(bodies):
        want = probes.plain(stage, body, x)
        outs = {key: torch.empty_like(want) for key in libs}
        calls[f"probe {stage}.{body}"] = {
            key: (lambda lib=lib, o=outs[key], s=kernels.PROBE_STAGES.index(stage), i=i: lib.mapper_probe_i16(
                s, i, x.data_ptr(), o.data_ptr(), 16384, probes.B, o.shape[1], stream()), outs[key], want)
            for key, lib in libs.items()}
        timers[f"probe {stage}.{body}"] = lambda fn: cs.graph_ms(fn, 50)

ratios = []
for name, by_key in calls.items():
    for key, (fn, out, want) in by_key.items():
        assert fn() == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), (name, key)
    times = {key: [] for key in by_key}
    for key in ["A", "B", "B", "A"]:
        times[key].append(timers[name](by_key[key][0]) * (1e3 if name.startswith("probe") else 1))
    a, b = np.mean(times["A"]), np.mean(times["B"])
    ratios.append(b / a)
    unit = "us" if name.startswith("probe") else "ms"
    print(f"{name}: A {a:.4f} {unit} ({', '.join(f'{t:.4f}' for t in times['A'])}), "
          f"B {b:.4f} {unit} ({', '.join(f'{t:.4f}' for t in times['B'])}), B/A {b / a:.3f}", flush=True)
print(f"B/A over {len(ratios)} kernels and bodies: median {np.median(ratios):.3f}, "
      f"min {min(ratios):.3f}, max {max(ratios):.3f}")
