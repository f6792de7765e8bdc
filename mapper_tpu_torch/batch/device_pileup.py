"""Device-side pileup accumulation for the batch engine: the port of
`mapper_tpu.batch.device_pileup` on a `torch.device`.

The reference's MatchDatabase.groupByPosition (Mapper.java:760-784) is a
host-side post-pass.  Here [2, 6 * N] allele/depth accumulators (middle and
end rows; A C G T ambiguous deletion) stay on the device, and each chunk's
clean ungapped emissions are added into them on the thread that decided
them, with two `index_add_` calls.  At write time the host copies the
accumulators once and adds them into the MatchDatabase pileups; the rarer
shapes (indels, mate overlap, fractional multi-choice weights, fallback
reads) keep the host accumulation.

Exactness: only weights 1.0 and 0.5 reach this path (the engine passes 1.0),
so every accumulated value is a sum of 0.5 steps, exact in float32 below
2^23 whatever order the atomic adds of `index_add_` take on the card.  The
outputs are therefore byte-identical to the host path's.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

ROWS = 6  # A C G T ambiguous deletion (pileup.py row order)
# compact positions above this keep the host path, so that both packages take
# the same path on the same reference (the JAX package caps for its int32 flat
# indices; the port's are int64, and its state here is 3.2 GB); the CLI logs it
MAX_POSITIONS = 2**26


class DevicePileup:
    """Per-run device accumulator over a compact forward-only coordinate
    space (the batch engine folds every match onto forward contigs, so
    reverse-complement segments are never hit; leaving them out halves the
    state and the merge-time copy)."""

    def __init__(self, seq_db, query_end_fraction: float, device):
        self.seq_db = seq_db
        self.query_end_fraction = float(query_end_fraction)
        # compact = global + _delta[seq_index]; reverse-complement rows keep
        # INT64_MIN so an accidental RC emission fails loudly
        starts = seq_db.starts
        fwd = [s.complemented_from is None for s in seq_db.get_all()]
        delta = np.full(len(fwd), np.iinfo(np.int64).min, dtype=np.int64)
        compact = 0
        self._fwd_compact_starts: list[tuple[int, int, int]] = []  # (db_i, lo, hi)
        for i, is_fwd in enumerate(fwd):
            if is_fwd:
                length = int(starts[i + 1] - starts[i])
                delta[i] = compact - int(starts[i])
                self._fwd_compact_starts.append((i, compact, compact + length))
                compact += length
        self._delta = delta
        self.n_concat = compact
        if self.n_concat > MAX_POSITIONS:
            raise ValueError(
                f"reference too large for device pileup: {self.n_concat} forward "
                f"positions, above {MAX_POSITIONS}"
            )
        self._device = torch.device(device)
        self._state = None  # [2, 6 * N] float32, created at the first rows
        self.num_rows_accumulated = 0
        # the CLI processes chunks on a thread pool: one update at a time
        self._lock = threading.Lock()
        self._merged = False

    def add_rows(self, batch, read_id, reversed_, gstart, n, weight) -> None:
        """Add one chunk's clean ungapped emissions.  `batch` is the engine's
        ReadBatch (concatenated uint8 codes and per-read starts); the other
        arguments are per-emitted-row host vectors."""
        b = len(read_id)
        if b == 0:
            return
        n = np.asarray(n, dtype=np.int64)
        # db-global start positions into the compact forward space
        gstart = np.asarray(gstart, dtype=np.int64)
        seq_idx = np.searchsorted(self.seq_db.starts, gstart, side="right") - 1
        gstart = gstart + self._delta[seq_idx]
        lq = int(n.max())
        host = {
            "codes": np.ascontiguousarray(batch.codes, dtype=np.uint8),
            "read_starts": np.asarray(batch.starts[:-1], dtype=np.int64),
            "read_id": np.asarray(read_id, dtype=np.int64),
            "reversed_": np.asarray(reversed_, dtype=bool),
            "gstart": gstart,
            "n": n,
            "weight": np.asarray(weight, dtype=np.float32),
        }
        with self._lock:
            dev = {k: torch.from_numpy(v).to(self._device) for k, v in host.items()}
            if self._state is None:
                self._state = torch.zeros(
                    (2, ROWS * self.n_concat), dtype=torch.float32, device=self._device
                )
            flat, mid, end = self._scatter_rows(lq, **dev)
            self._state[0].index_add_(0, flat, mid)
            self._state[1].index_add_(0, flat, end)
            self.num_rows_accumulated += b

    def _scatter_rows(self, lq, codes, read_starts, read_id, reversed_, gstart, n, weight):
        """Flat state indices [B * LQ] and the middle and end weights added
        there (`core` of the JAX package's update)."""
        pos = torch.arange(lq, device=codes.device)[None, :]
        src = torch.clamp(read_starts[read_id][:, None] + pos, max=codes.shape[0] - 1)
        q = codes[src].to(torch.int32)  # [B, LQ]
        # reverse complement: complement = nibble bit-reversal
        comp = ((q & 1) << 3) | ((q & 2) << 1) | ((q & 4) >> 1) | ((q & 8) >> 3)
        rc_idx = torch.clamp(n[:, None] - 1 - pos, 0, lq - 1)
        rc = torch.take_along_dim(comp, rc_idx, dim=1)
        q = torch.where(reversed_[:, None], rc, q)
        # code -> allele row: A/C/G/T are one-hot nibbles, anything else is
        # the ambiguous row
        row = torch.full_like(q, 4)
        for code, r in ((1, 0), (2, 1), (4, 2), (8, 3)):
            row = torch.where(q == code, r, row)
        valid = pos < n[:, None]
        dist_end = torch.minimum(pos, n[:, None] - 1 - pos).to(torch.float32)
        qef = torch.tensor(self.query_end_fraction, dtype=torch.float32)
        is_end = dist_end < n[:, None].to(torch.float32) * qef
        flat = torch.where(valid, row.to(torch.int64) * self.n_concat + gstart[:, None] + pos, 0)
        w = torch.where(valid, weight[:, None], 0.0)
        mid = torch.where(is_end, 0.0, w)
        end = torch.where(is_end, w, 0.0)
        return flat.reshape(-1), mid.reshape(-1), end.reshape(-1)

    def merge_into(self, match_database) -> None:
        """Copy the accumulators to the host once, as float64, and add them
        into the MatchDatabase's per-contig pileups."""
        if self._state is None or self._merged:
            return
        self._merged = True
        state = self._state.cpu().numpy().astype(np.float64).reshape(2, ROWS, self.n_concat)
        for i, lo, hi in self._fwd_compact_starts:
            if not state[:, :, lo:hi].any():
                continue
            pileup = match_database._pileup_for(self.seq_db.get_sequence(i))
            pileup.middle += state[0, :, lo:hi]
            pileup.end += state[1, :, lo:hi]
