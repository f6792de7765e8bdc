"""Entry points of the port (the counterpart of the root
`__graft_entry__.py`).

- `entry(device=None)`: a single-card forward step on the flagship compute
  path, the banded-DP extend scorer over a simulated batch of 64 reads (LQ
  64, band 32), and its example arguments as int32 tensors on `device`
  (default `cuda`).  The step is `banded.banded_scores(..., band=32)`, the
  "pen" route, the port's counterpart of the jitted `_banded_scores_jnp`.
  `banded_scores` pads the query width to 128 (`DEFAULT_CHUNK`), where
  `_quantize_params` finds the exact scale 30 for the default penalties, so
  the step takes the int16 route: on the card `kernels.banded_i16` with its
  block kernel (`banded_kernel<I16Ops>`, `align/csrc/banded_dp.cu`), since
  band 32 is not a warp band; on the CPU its plain version.
- `dryrun_multichip(n_devices)`: the reference's five checks on a mesh of the
  first `n_devices` of `parallel.mesh.visible_devices()`: sharded extend
  scoring, the per-shard depth scatter summed by `reduce_pileup` (the psum),
  `ShardedIndex.lookup`, the mesh engine on single-end and paired queries,
  and the CLI with `--devices N` byte-identical to `--devices 1`.  It raises
  when fewer than `n_devices` devices are visible: unlike the reference it
  never falls back to the CPU (`MAPPER_TPU_TORCH_CPU_DEVICES` asks for a CPU
  mesh).  Each check is a function of its own in `CHECKS`.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np
import torch

BAND = 32
LQ = 64
REF_LEN = 512  # the pileup check's reference length


def _simulated_batch(batch=64, lq=64, band=32, shift=8, seed=0):
    rng = np.random.default_rng(seed)
    bases = np.array([1, 2, 4, 8], dtype=np.uint8)
    qs, ws, ns, ms = [], [], [], []
    for i in range(batch):
        n = int(rng.integers(lq // 2, lq))
        ref = bases[rng.integers(0, 4, size=n + 2 * shift)]
        q = np.array(ref[shift : shift + n])
        if n > 10:
            q[int(rng.integers(0, n))] = bases[rng.integers(0, 4)]
        qs.append(np.pad(q, (0, lq - n)))
        ws.append(np.pad(ref, (0, lq + band - len(ref))))
        ns.append(n)
        ms.append(len(ref))
    return (
        np.stack(qs).astype(np.int32),
        np.stack(ws).astype(np.int32),
        np.array(ns, dtype=np.int32),
        np.array(ms, dtype=np.int32),
    )


def entry(device=None):
    """Returns (step, example_args): the batched banded-DP extend scoring step
    under the production penalty model, and the simulated batch on `device`
    (default `cuda`)."""
    from mapper_tpu_torch.align import banded
    from mapper_tpu_torch.align.params import AlignmentParameters

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: no CUDA device is available (pass device='cpu' for the plain versions)")
    params = AlignmentParameters.defaults()

    def step(q_codes, w_codes, n, m):
        return banded.banded_scores(q_codes, w_codes, n, m, params, band=BAND)

    q, w, n, m = _simulated_batch(batch=64, lq=LQ, band=BAND)
    return step, tuple(torch.as_tensor(a, device=device) for a in (q, w, n, m))


# ---- dryrun_multichip's checks, each on a mesh ----------------------------


def _require(condition, message: str = "dryrun check failed") -> None:
    if not condition:
        raise AssertionError(message)


def _dryrun_reference():
    rng = np.random.default_rng(2)
    return rng, "".join(rng.choice(list("ACGT"), size=4000))


def check_scores(mesh) -> torch.Tensor:
    """1: extend scoring sharded over the mesh equals one device's scores.
    Returns the scores, on the mesh's first device."""
    from mapper_tpu_torch.align import banded
    from mapper_tpu_torch.align.params import AlignmentParameters
    from mapper_tpu_torch.parallel.mesh import sharded_banded_scores

    batch = 8 * len(mesh)
    arrays = _simulated_batch(batch=batch, lq=LQ, band=BAND)
    params = AlignmentParameters.defaults()
    scores = sharded_banded_scores(mesh, params, BAND)(*arrays)
    one = banded.banded_scores(*(torch.as_tensor(a, device=mesh[0]) for a in arrays), params, BAND)
    _require(scores.shape == (batch,) and bool(torch.isfinite(scores).all()))
    _require(torch.equal(scores, one), "sharded scores differ from one device's")
    return scores


def check_pileup(mesh, scores: torch.Tensor | None = None) -> float:
    """2: accepted-read depth scattered into one accumulator per mesh entry,
    summed by `reduce_pileup` (the psum fan-in), equals one scatter of all
    reads.  Scores the batch first unless `scores` are given.  Returns the
    depth's sum."""
    from mapper_tpu_torch.parallel.mesh import reduce_pileup, shard_bounds

    if scores is None:
        scores = check_scores(mesh)
    batch = scores.shape[0]
    _, _, n, _ = _simulated_batch(batch=batch, lq=LQ, band=BAND)
    offsets = np.random.default_rng(1).integers(0, REF_LEN - LQ, size=batch)
    lanes = torch.arange(LQ)
    pos = torch.as_tensor(offsets)[:, None] + lanes[None, :]
    covered = lanes[None, :] < torch.as_tensor(n)[:, None]
    weights = (covered & (scores.cpu() <= 16.0)[:, None]).to(torch.float32)
    depths = []
    for device, (lo, hi) in zip(mesh, shard_bounds(mesh, batch)):
        depth = torch.zeros(REF_LEN, device=device)
        depth.index_add_(0, pos[lo:hi].reshape(-1).to(device), weights[lo:hi].reshape(-1).to(device))
        depths.append(depth)
    total = reduce_pileup(mesh, depths).cpu()
    want = torch.zeros(REF_LEN).index_add_(0, pos.reshape(-1), weights.reshape(-1))
    _require(total.shape == (REF_LEN,) and bool(torch.isfinite(total).all()))
    _require(torch.equal(total, want) and total.sum() > 0, "the merged depth differs from one scatter")
    return float(total.sum())


def check_sharded_index(mesh) -> int:
    """3: the hash-range sharded index answers every seed.  Returns the number
    of seeds looked up."""
    from mapper_tpu_torch import Api
    from mapper_tpu_torch.batch.candidates import ReadBatch, collect_batch_seeds
    from mapper_tpu_torch.parallel.sharded_index import ShardedIndex
    from mapper_tpu_torch.sequence import Sequence

    rng, ref_text = _dryrun_reference()
    db = Api.new_database({"c": ref_text}).hashblock_database
    reads = [Sequence.from_text(f"r{i}", ref_text[int(rng.integers(0, 3800)) :][:150]) for i in range(8)]
    seg, _, _, num_bp, key, _ = collect_batch_seeds(ReadBatch.from_sequences(reads), db)
    vals, counts, valid = ShardedIndex(db, mesh, k_match=8).lookup(num_bp, key)
    _require(vals.shape == (seg.shape[0], 8) and valid.any() and (counts > 0).all())
    return int(vals.shape[0])


def check_engine(mesh) -> tuple[int, int]:
    """4: the engine on the mesh, single-end and paired queries, all aligned.
    Returns (aligned, queries)."""
    from mapper_tpu_torch import AlignmentParameters, Api, basepairs
    from mapper_tpu_torch.align.query import Query
    from mapper_tpu_torch.batch.engine import BatchAligner
    from mapper_tpu_torch.sequence import Sequence

    _, ref_text = _dryrun_reference()
    rng = np.random.default_rng(3)
    index = Api.new_database({"c": ref_text})
    engine = BatchAligner(index, AlignmentParameters.defaults(), mesh=mesh, pipeline_chunk_reads=None)
    queries = []
    for i in range(2 * len(mesh)):
        pos = int(rng.integers(0, 3400))
        frag = ref_text[pos : pos + 300]
        if i % 2 == 0:
            queries.append(Query(Sequence.from_text(f"q{i}", frag[:100])))
        else:
            mate = basepairs.decode(basepairs.reverse_complement(basepairs.encode(frag[-100:])))
            queries.append(Query(
                Sequence.from_text(f"q{i}/1", frag[:100]), Sequence.from_text(f"q{i}/2", mate),
                expected_inner_distance=100, spacing_deviation_per_unit_penalty=50,
            ))
    results = engine.process_batch(queries, notify=False)
    aligned = sum(1 for r in results if r is not None and r.get_first_alignments())
    _require(aligned == len(queries), f"{aligned}/{len(queries)} aligned on the mesh")
    return aligned, len(queries)


def check_cli(mesh) -> None:
    """5: the CLI with `--devices N` (N the mesh's size, on the mesh's device
    type) writes the SAM of `--devices 1`."""
    from mapper_tpu_torch import cli

    rng, ref_text = _dryrun_reference()
    with tempfile.TemporaryDirectory(prefix="dryrun_cli_") as tmp:
        root = Path(tmp)
        (root / "ref.fasta").write_text(">c\n" + ref_text + "\n")
        (root / "reads.fasta").write_text("".join(
            f">cr{i}\n{ref_text[p : p + 120]}\n"
            for i, p in enumerate(int(rng.integers(0, 3800)) for _ in range(4 * len(mesh)))
        ))
        before = os.environ.get("MAPPER_TPU_TORCH_DEVICE")
        os.environ["MAPPER_TPU_TORCH_DEVICE"] = mesh[0].type
        sams = {}
        try:
            for nd in (1, len(mesh)):
                sam = root / f"out{nd}.sam"
                rc = cli.main([
                    "--reference", str(root / "ref.fasta"), "--queries", str(root / "reads.fasta"),
                    "--out-sam", str(sam), "--devices", str(nd),
                ])
                _require(rc == 0, f"CLI --devices {nd} failed")
                sams[nd] = sam.read_text()
        finally:
            if before is None:
                os.environ.pop("MAPPER_TPU_TORCH_DEVICE", None)
            else:
                os.environ["MAPPER_TPU_TORCH_DEVICE"] = before
    _require(sams[1] == sams[len(mesh)], "the CLI's SAM differs across device counts")
    _require(sams[1].count("\n") > 4 * len(mesh))


CHECKS = {
    "scores": check_scores,
    "pileup": check_pileup,
    "sharded_index": check_sharded_index,
    "engine": check_engine,
    "cli": check_cli,
}


def dryrun_multichip(n_devices: int) -> None:
    """The five checks on a mesh of the first `n_devices` visible devices
    (`parallel.mesh.visible_devices()`: every card, or the CPU entries that
    MAPPER_TPU_TORCH_CPU_DEVICES asks for), then one summary line."""
    from mapper_tpu_torch.parallel.mesh import make_mesh, visible_devices

    devices = visible_devices()
    if len(devices) < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): only {len(devices)} devices visible")
    mesh = make_mesh(devices[:n_devices])
    scores = check_scores(mesh)
    depth = check_pileup(mesh, scores)
    lookups = check_sharded_index(mesh)
    aligned, queries = check_engine(mesh)
    check_cli(mesh)
    print(
        f"dryrun_multichip({n_devices}): ok on {mesh[0].type} — scores {tuple(scores.shape)}, "
        f"pileup depth sum {depth:.1f}, sharded-index lookups {lookups}, "
        f"mesh engine aligned {aligned}/{queries}, CLI --devices {n_devices} byte-identical to 1"
    )
