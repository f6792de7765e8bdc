"""Multi-device scaling: data-parallel sharding of the alignment pipeline
over a mesh of torch devices (the port of `mapper_tpu.parallel.mesh`).

A mesh is an ordered tuple of `torch.device`s, the counterpart of the JAX
package's 1-D `data` mesh.  The same device may appear more than once: that
is how one card runs several shards.

- candidate rows shard over the mesh in contiguous slices, in mesh order,
  and each shard is scored on its own device (no collectives);
- the reference and the read matrix replicate: one copy per distinct device;
- per-device pileup accumulators merge by a sum on the mesh's first device
  (`reduce_pileup`), the JAX package's `psum`.

On the card each shard runs on a CUDA stream of its own, under a device guard
for its device, and the caller's current stream on the mesh's first device
waits on every shard before anything reads the result.  One process drives
every device, so no process group is needed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# the number of CPU entries `visible_devices` gives without a card
CPU_DEVICES_ENV = "MAPPER_TPU_TORCH_CPU_DEVICES"


def visible_devices(device_type: str | None = None) -> list[torch.device]:
    """The devices of `device_type` a mesh may take: every CUDA card for
    "cuda" (none without a card); for "cpu", N entries of the CPU, where N
    is MAPPER_TPU_TORCH_CPU_DEVICES (default 1).  With no type given, "cpu"
    where that variable is set and "cuda" elsewhere: the CPU is taken only
    when asked for.  Only tests set the variable: it is the counterpart of
    the `--xla_force_host_platform_device_count=8` that gives the JAX
    package's tests a CPU mesh of several devices."""
    if device_type is None:
        device_type = "cpu" if CPU_DEVICES_ENV in os.environ else "cuda"
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_type != "cpu":
        raise ValueError(f"no mesh of {device_type} devices")
    count = int(os.environ.get(CPU_DEVICES_ENV, "1"))
    if count < 1:
        raise ValueError(f"{CPU_DEVICES_ENV}={count}: must be >= 1")
    return [torch.device("cpu")] * count


def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """The mesh over `devices` (default: `visible_devices()`), in order.  All
    entries are CPU devices or all are CUDA devices; a CUDA entry without an
    index names the current card.  With no devices given and no card, it
    raises unless MAPPER_TPU_TORCH_CPU_DEVICES asks for the CPU."""
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise ValueError(
                f"no CUDA device is visible: pass the devices, or set {CPU_DEVICES_ENV} for a CPU mesh"
            )
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    kinds = {d.type for d in mesh}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh is all CPU or all CUDA devices, got {mesh}")
    return tuple(mesh)


def shard_bounds(mesh, rows: int) -> list[tuple[int, int]]:
    """Contiguous row ranges, one per mesh entry in mesh order, whose sizes
    differ by at most one (the first `rows % len(mesh)` take one more)."""
    size, extra = divmod(rows, len(mesh))
    bounds, lo = [], 0
    for i in range(len(mesh)):
        hi = lo + size + (i < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _to(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def shard_batch(mesh, *arrays):
    """Split batch-major arrays (numpy or tensors, the same number of rows)
    into contiguous slices in mesh order and move each slice to its entry's
    device.  Returns, per array, the list of its slices."""
    rows = len(arrays[0])
    if any(len(a) != rows for a in arrays):
        raise ValueError("shard_batch: the arrays have different row counts")
    bounds = shard_bounds(mesh, rows)
    return tuple([_to(a[lo:hi], d) for d, (lo, hi) in zip(mesh, bounds)] for a in arrays)


def replicate(mesh, *arrays):
    """Copy each array to every mesh device, once per distinct device (the
    entries of one device share its copy).  Returns, per array, the list of
    its copies in mesh order."""
    out = []
    for a in arrays:
        copies = {}
        for d in mesh:
            if d not in copies:
                copies[d] = _to(a, d)
        out.append([copies[d] for d in mesh])
    return tuple(out)


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def on_shards(mesh, fn, shard_args) -> list:
    """`fn(device, *args)` for each mesh entry with its `shard_args` entry.
    On the card each runs on a stream of its own under a device guard, after
    the caller's current stream on its device; the caller's current stream
    on the mesh's first device then waits on every shard.  The tensors each
    shard reads and returns are kept alive for the streams that use them."""
    if mesh[0].type == "cpu":
        return [fn(d, *args) for d, args in zip(mesh, shard_args)]
    streams, outs = [], []
    for d, args in zip(mesh, shard_args):
        with torch.cuda.device(d):
            stream = torch.cuda.Stream(d)
            stream.wait_stream(torch.cuda.current_stream(d))
            for t in _tensors(args):
                t.record_stream(stream)
            with torch.cuda.stream(stream):
                outs.append(fn(d, *args))
            streams.append(stream)
    with torch.cuda.device(mesh[0]):
        join = torch.cuda.current_stream(mesh[0])
        for stream, out in zip(streams, outs):
            join.wait_stream(stream)
            for t in _tensors(out):
                if t.device == mesh[0]:
                    t.record_stream(join)
    return outs


def sharded_banded_scores(mesh, params, band: int):
    """A data-sharded version of the banded scoring step: `run(q_codes,
    w_codes, n, m)` splits the host-built rows over the mesh and scores each
    shard with `banded.banded_scores` on its device (the plain version on
    the CPU, K1, K2 or K3 on the card), with no collectives.  Returns the
    scores, [B] float32 on the mesh's first device, in row order."""
    from mapper_tpu_torch.align import banded

    def shard(device, q, w, n, m):
        scores = banded.banded_scores(q, w, n, m, params, band)
        return scores.to(mesh[0])

    def run(q_codes, w_codes, n, m):
        outs = on_shards(mesh, shard, list(zip(*shard_batch(mesh, q_codes, w_codes, n, m))))
        return torch.cat(outs)

    return run


def reduce_pileup(mesh, shard_counts) -> torch.Tensor:
    """Sum per-device pileup count tensors (one per mesh entry; the
    VCF/mutations "groupByPosition" merge) on the mesh's first device, in
    mesh order.  Every count is a multiple of 0.5 far below 2^24, so the
    float32 sums are exact in any order."""
    if len(shard_counts) != len(mesh):
        raise ValueError(f"{len(shard_counts)} count tensors for a mesh of {len(mesh)}")
    if len(mesh) == 1:
        return shard_counts[0].to(mesh[0])
    total = shard_counts[0].to(mesh[0], copy=True)
    for counts in shard_counts[1:]:
        total += counts.to(mesh[0])
    return total
