"""The port's hash-range sharded index (`mapper_tpu_torch.parallel.
sharded_index`) against the host merged-index walk and the JAX package's
`ShardedIndex` on its 8 virtual CPU devices, on the same seeds.  Mirrors
tests/test_sharded_index.py.  The JAX index is built over the port's
database: its `merged_index()` holds the JAX package's arrays
(tests/test_torch_host_copies.py::test_index_arrays_equal)."""

import jax
import numpy as np
import pytest
import torch

from mapper_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mapper_tpu.parallel.sharded_index import ShardedIndex as JaxShardedIndex
from mapper_tpu_torch import Api
from mapper_tpu_torch.batch.candidates import ReadBatch, collect_batch_seeds
from mapper_tpu_torch.parallel.sharded_index import ShardedIndex
from mapper_tpu_torch.sequence import Sequence

CPU = torch.device("cpu")


def _seeds(ref_text, contigs, num_reads, read_span, seed):
    rng = np.random.default_rng(seed)
    index = Api.new_database(contigs)
    db = index.hashblock_database
    reads = []
    for i in range(num_reads):
        pos = int(rng.integers(0, read_span - 160))
        reads.append(Sequence.from_text(f"r{i}", ref_text[pos : pos + 150]))
    seg, _, _, num_bp, key, _ = collect_batch_seeds(ReadBatch.from_sequences(reads), db)
    return db, seg, num_bp, key


def _host_walk(db, num_bp, key, k_match=12):
    """The expected (positions, counts, valid) from the merged index."""
    merged = db.merged_index()
    bins = merged["bases"][num_bp] + np.remainder(key, merged["capacities"][num_bp])
    counts = merged["counts"][bins]
    take = np.minimum(counts, np.minimum(merged["caps"][num_bp], k_match))
    j = np.arange(k_match)[None, :]
    valid = j < take[:, None]
    vidx = np.minimum(merged["offsets"][bins][:, None] + j, len(merged["values"]) - 1)
    return np.where(valid, merged["values"][vidx], 0), counts, valid


def _check(sharded, jax_sharded, db, num_bp, key):
    vals, counts, valid = sharded.lookup(num_bp, key)
    want_vals, want_counts, want_valid = _host_walk(db, num_bp, key)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(np.where(valid, vals, 0), want_vals)
    np.testing.assert_array_equal(vals[~valid], 0)  # non-owners and unused slots add zeros
    j_vals, j_counts, j_valid = jax_sharded.lookup(num_bp, key)
    np.testing.assert_array_equal(vals, j_vals)
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(valid, j_valid)
    return valid


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(2)
    ref_text = "".join(rng.choice(list("ACGT"), size=20000))
    db, seg, num_bp, key = _seeds(ref_text, {"c1": ref_text[:15000], "c2": ref_text[15000:]}, 24, 15000, 3)
    assert seg.shape[0] > 0
    return db, num_bp, key, JaxShardedIndex(db, jax_make_mesh(jax.devices()), k_match=12)


@pytest.mark.parametrize("entries", [1, 2, 3, 8])
def test_sharded_lookup_matches_host(small, entries):
    """Mirrors tests/test_sharded_index.py::test_sharded_lookup_matches_host
    on meshes of 1, 2, 3 and 8 CPU entries."""
    db, num_bp, key, jax_sharded = small
    sharded = ShardedIndex(db, (CPU,) * entries, k_match=12)
    assert len(sharded.shards) == entries
    assert all(t.device == CPU for shard in sharded.shards for t in shard)
    valid = _check(sharded, jax_sharded, db, num_bp, key)
    assert valid.any()


def test_sharded_lookup_scale_multi_mb():
    """Mirrors tests/test_sharded_index.py::test_sharded_lookup_scale_multi_mb:
    a 4.6 Mb reference, thousands of seeds from 512 reads, the host walk's
    and the JAX index's answers, and the value-balanced layout's device
    memory for values within 1.3x of the unsharded array."""
    rng = np.random.default_rng(46)
    ref_text = "".join(rng.choice(list("ACGT"), size=4_600_000))
    db, seg, num_bp, key = _seeds(ref_text, {"chr": ref_text}, 512, 4_600_000, 47)
    assert seg.shape[0] > 5000  # thousands of seeds
    sharded = ShardedIndex(db, (CPU,) * 8, k_match=12)
    jax_sharded = JaxShardedIndex(db, jax_make_mesh(jax.devices()), k_match=12)
    assert sharded.values_memory_ratio <= 1.3
    assert sharded.values_memory_ratio == jax_sharded.values_memory_ratio
    assert sharded.bins_per_shard == jax_sharded.bins_per_shard
    valid = _check(sharded, jax_sharded, db, num_bp, key)
    assert valid.sum() > 5000
