"""Hash-range sharding of the packed index across a device mesh (the port of
`mapper_tpu.parallel.sharded_index`).

For reference sets whose index exceeds one device's memory, the merged
PackedIndex bins (index/database.py::merged_index) split into contiguous bin
ranges, one per mesh entry.  Seed keys are small and replicate to every
device; each shard answers only the bins it owns, non-owners answer zeros,
and the answers are summed on the mesh's first device (the JAX package's
`psum`).  The gathers and adds are PyTorch tensor operations on each shard's
device, the counterpart of the JAX package's `shard_map` of `jnp` gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from mapper_tpu_torch.parallel.mesh import make_mesh, on_shards, replicate


class ShardedIndex:
    """Device-sharded view of a database's merged index.

    Lookup semantics mirror the host path (batch/candidates.py): a seed's bin
    is ``bases[num_bp] + key mod capacities[num_bp]``; bins whose count
    exceeds the per-size cap are "too popular" and report their count but no
    positions.
    """

    def __init__(self, database, mesh, k_match: int = 12):
        merged = database.merged_index()
        counts = np.asarray(merged["counts"], dtype=np.int32)
        offsets = np.asarray(merged["offsets"], dtype=np.int64)
        values = np.asarray(merged["values"], dtype=np.int64)
        self.capacities = merged["capacities"]
        self.caps = merged["caps"]
        self.bases = merged["bases"]
        self.mesh = make_mesh(mesh)
        self.k_match = k_match

        n_dev = len(self.mesh)
        num_bins = counts.shape[0]
        n_values = values.shape[0]
        # value-balanced contiguous bin ranges: shard boundaries sit where the
        # cumulative value count crosses d/n_dev of the total, so every
        # shard's values slice is ~n_values/n_dev and the pad-to-max below
        # costs only the boundary imbalance
        targets = (np.arange(1, n_dev, dtype=np.int64) * n_values) // n_dev
        bounds = np.searchsorted(offsets[:num_bins], targets, side="left")
        bounds = np.concatenate(([0], bounds, [num_bins]))
        bounds = np.maximum.accumulate(bounds)
        self.bins_per_shard = max(1, int(np.max(bounds[1:] - bounds[:-1], initial=1)))

        shard_counts, shard_offsets, shard_values, base_bins = [], [], [], []
        for d in range(n_dev):
            lo = int(bounds[d])
            hi = int(bounds[d + 1])
            v_lo = int(offsets[lo]) if lo < num_bins else n_values
            v_hi = int(offsets[hi]) if hi < num_bins else n_values
            c = np.zeros(self.bins_per_shard, dtype=np.int32)
            o = np.zeros(self.bins_per_shard, dtype=np.int64)
            c[: hi - lo] = counts[lo:hi]
            o[: hi - lo] = offsets[lo:hi] - v_lo
            shard_counts.append(c)
            shard_offsets.append(o)
            shard_values.append(values[v_lo:v_hi])
            base_bins.append(lo)
        vmax = max((v.shape[0] for v in shard_values), default=0) or 1
        # total device memory for values = n_dev * vmax ~= n_values + slack
        self.values_memory_ratio = (n_dev * vmax) / max(1, n_values)
        shard_values = [np.pad(v, (0, vmax - v.shape[0]), constant_values=0) for v in shard_values]

        # per shard: (counts, offsets, values) on its device, and its first bin
        self.shards = [
            tuple(torch.from_numpy(a).to(device) for a in arrays)
            for device, arrays in zip(self.mesh, zip(shard_counts, shard_offsets, shard_values))
        ]
        self.base_bins = base_bins

    def _shard_lookup(self, device, shard, base: int, bins, limits):
        """One shard's answer: its owned seeds' positions, counts and valid
        mask, zeros for every other seed."""
        counts_s, offsets_s, values_s = shard
        local = bins - base
        mine = (local >= 0) & (local < self.bins_per_shard)
        local_c = torch.clamp(local, 0, self.bins_per_shard - 1)
        c = torch.where(mine, counts_s[local_c], 0).to(torch.int64)
        start = offsets_s[local_c]
        j = torch.arange(self.k_match, dtype=torch.int64, device=device)[None, :]
        take = torch.minimum(c, torch.clamp(limits, max=self.k_match))
        valid = mine[:, None] & (j < take[:, None])
        vidx = torch.clamp(start[:, None] + j, 0, values_s.shape[0] - 1)
        vals = torch.where(valid, values_s[vidx], 0)
        return vals, c, valid.to(torch.int32)

    def lookup(self, num_bp: np.ndarray, keys: np.ndarray):
        """Batched sharded lookup.  Returns (positions [S, k_match], counts
        [S], valid [S, k_match]) as numpy arrays — count reflects the bin
        even when too popular to enumerate (cap semantics as the host path)."""
        num_bp = np.asarray(num_bp, dtype=np.int64)
        keys = np.asarray(keys, dtype=np.int64)
        cap_per_seed = self.capacities[num_bp]
        bins = np.asarray(self.bases[num_bp] + np.remainder(keys, cap_per_seed), dtype=np.int64)
        limits = np.asarray(self.caps[num_bp], dtype=np.int64)
        bins_d, limits_d = replicate(self.mesh, bins, limits)
        answers = on_shards(
            self.mesh,
            self._shard_lookup,
            list(zip(self.shards, self.base_bins, bins_d, limits_d)),
        )
        # owners contribute; everyone else adds zeros
        vals, counts, valid = (t.to(self.mesh[0]).clone() for t in answers[0])
        for answer in answers[1:]:
            for total, part in zip((vals, counts, valid), answer):
                total += part.to(self.mesh[0])
        return vals.cpu().numpy(), counts.cpu().numpy(), valid.cpu().numpy().astype(bool)
