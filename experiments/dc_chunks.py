"""The device-candidates chunks of `chip_smoke.py`'s phase 7 on the card, and
KC1 (`mapper_candidates`) and KC2 (`mapper_fused_rows`) called from any
build of `mapper_tpu_torch/align/csrc/`, for the experiments that time them
(`experiments/csrc_ab.py`, `experiments/candidates_stages.py`).

`phase7_chunks(root)` simulates chip_smoke.py's inputs under `root`, or
under `$MAPPER_TPU_DC_CHUNKS` where the experiments of one command share
them (the same seeds: a 4.6 Mb reference, 100,000 reads of 150 bp, 2,000
of 1,000 bp, 20,000 pairs), builds the reference's index as the CLI does,
and returns
the four chunks of `chip_smoke.dc_batches` as `fused_inputs` on the card
with the engine's band: 150 bp (4,096 reads), 1,000 bp (2,000), the paired
mates (4,096) and one 5,000 bp read.  Needs a card.
"""
from __future__ import annotations

import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402  (it also keeps JAX out of this process)

K_OUT = 8


def phase7_chunks(root: Path) -> dict:
    """tag -> (fused_inputs, band) of chip_smoke.py's phase 7 chunks; inputs
    already simulated there are reused."""
    root = Path(os.environ.get("MAPPER_TPU_DC_CHUNKS", root))
    root.mkdir(parents=True, exist_ok=True)
    import torch

    from mapper_tpu_torch.align.params import AlignmentParameters
    from mapper_tpu_torch.batch import device_candidates as dc
    from mapper_tpu_torch.batch.engine import single_end_band, upload_reference

    t0 = time.time()
    if not (root / "pairs_2.fasta").exists():
        cs.simulate_inputs(root, 4_600_000, 100_000, 2_000, 20_000, 0)
    db = cs.load_database(root)
    concat = upload_reference(db.get_sequence_database().concatenated_codes(), torch.device("cuda"))
    params = AlignmentParameters.defaults()
    chunks = {}
    for tag, batch in cs.dc_batches(root).items():
        band, shift = single_end_band(batch.lengths, params)
        chunks[tag] = (dc.fused_inputs(batch, db, concat, shift, band), band)
    print(f"[chunks] simulated, indexed and uploaded in {time.time() - t0:.1f} s", flush=True)
    return chunks


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def kc1_call(lib, inputs):
    """(launch, out): launch() runs the build's KC1 on `inputs` into `out`
    and returns its CUDA error."""
    import torch

    from mapper_tpu_torch.align import kernels

    codes = inputs["codes"]
    out = torch.empty((codes.shape[0], 2 * K_OUT + 1), dtype=torch.int32, device=codes.device)
    grid, scratch = kernels.candidates_grid(codes.shape[1], codes.shape[0], codes.device)
    args = [inputs[k] for k in ("codes", "lengths", "index", "max_size", "min_size", "n_seqs", "span", "bias")]

    def launch():
        return lib.mapper_candidates(*kernels._candidates_args(*args, K_OUT, out, scratch, grid, _stream()))

    launch.scratch = scratch
    return launch, out


def takes_status(csrc: Path) -> bool:
    """Whether the build's mapper_fused_rows takes the look-back status
    words (the parent of the many-block KC2 does not)."""
    text = (csrc / "candidates.cu").read_text()
    params = text[text.index('extern "C" int mapper_fused_rows('):]
    return "status" in params[: params.index(")")]


def kc2_call(lib, csrc: Path, table, inputs, band):
    """(launch, rows): launch() runs the build's KC2 on `table` (updated in
    place, as the wrapper does) into the six row vectors and returns its
    CUDA error.  A build that takes status words gets them zeroed in every
    call, as the wrapper allocates them."""
    import ctypes

    import torch

    from mapper_tpu_torch.align import kernels
    from mapper_tpu_torch.batch import device_candidates as dc

    b = table.shape[0]
    c_slots = dc.score_rows(b)
    device = table.device
    rows = [torch.empty(c_slots, dtype=dt, device=device)
            for dt in (torch.int64, torch.bool, torch.int64, torch.int64, torch.int32, torch.int32)]
    index = inputs["index"]
    head = [table.data_ptr(), b, K_OUT, inputs["lengths"].data_ptr(), inputs["shift"].data_ptr(),
            index["seq_lengths"].data_ptr(), index["seq_starts"].data_ptr(), inputs["n_seqs"], inputs["span"],
            inputs["bias"], c_slots, band, *(t.data_ptr() for t in rows)]
    if takes_status(csrc):
        status = torch.empty(kernels.fused_rows_status_words(b), dtype=torch.int64, device=device)

        def launch():
            status.zero_()
            return lib.mapper_fused_rows(*head, status.data_ptr(), _stream())
    else:
        lib.mapper_fused_rows.argtypes = kernels._SIGNATURES["mapper_fused_rows"][:18] + [ctypes.c_void_p]

        def launch():
            return lib.mapper_fused_rows(*head, _stream())
    return launch, rows


def build_label(csrc: Path) -> str:
    """The build's KC1 design in a few words, from its source."""
    text = (csrc / "candidates.cu").read_text()
    found = {name: re.search(rf"constexpr int {name} = (\d+);", text)
             for name in ("kNarrowWarps", "kNarrowReads", "kNarrowWidth", "kWideWarps")}
    if not all(found.values()):
        return "one block of 256 threads a read"
    warps, reads, width, wide = (int(m.group(1)) for m in found.values())
    return f"teams of {warps} warps, {reads} reads a block, to width {width}; {wide} warps a read above"
