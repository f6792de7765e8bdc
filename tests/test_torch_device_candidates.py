"""The port's device-candidates path (`mapper_tpu_torch/batch/device_candidates.py`)
on `torch.device("cpu")` against the JAX package's
(`mapper_tpu/batch/device_candidates.py`, on JAX's CPU backend) and against
the port's host candidate pass, on the same references and reads built from
numpy seeds.

Exact: mergeHashes on adversarial inputs, the candidate tables and fallback
ids, the fused program's int32 table.  The fused scores are the port's
banded scorer (int16 units at 150 bp) against the JAX fused program's
float32 scores on the CPU: within `tests/test_pallas_dp.py`'s tolerances,
1e-4 for the banded score and 1e-3 for the ungapped diagonal sum."""

import numpy as np
import pytest
import torch

import mapper_tpu
from mapper_tpu.align.query import Query as JaxQuery
from mapper_tpu.batch import device_candidates as jax_dc
from mapper_tpu.batch.candidates import ReadBatch as JaxReadBatch
from mapper_tpu.batch.engine import BatchAligner as JaxBatchAligner
from mapper_tpu.sequence import Sequence as JaxSequence
from mapper_tpu_torch import Api, AlignmentParameters, basepairs
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.batch import device_candidates as dc
from mapper_tpu_torch.batch.candidates import ReadBatch, generate_candidates
from mapper_tpu_torch.batch.engine import BatchAligner, single_end_band
from mapper_tpu_torch.index import hashblock as hb
from mapper_tpu_torch.sequence import Sequence
import torch_candidate_workloads as wl

CPU = torch.device("cpu")
BANDED_ATOL = 1e-4
UNGAPPED_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scorer's many small tensor operations run no faster on
    several threads, and the suite runs in several processes at once, whose
    thread pools would contend for the cores: one intra-op thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Java integer arithmetic
# ---------------------------------------------------------------------------


def test_merge_hashes_exact_on_adversarial_inputs():
    """mergeHashes in int64 tensors equals the port's numpy `_merge_hashes`
    and the JAX package's uint32-limb version on INT_MIN/INT_MAX, sign flips
    and wraps, bit for bit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    special = np.array([-(2**31), 2**31 - 1, -1, 0, 1, 54323, -54323, 2**30, -(2**30), -2, 2**31 - 2],
                       dtype=np.int64)
    l_hash = np.concatenate([special, np.repeat(special, special.size), rng.integers(-(2**31), 2**31, 500)])
    r_hash = np.concatenate([special[::-1], np.tile(special, special.size), rng.integers(-(2**31), 2**31, 500)])
    l_len = np.concatenate([rng.integers(1, 400, size=l_hash.size - 2), [1, 2047]])
    r_len = np.concatenate([rng.integers(1, 400, size=l_hash.size - 2), [2047, 1]])
    want = hb._merge_hashes(l_len, l_hash.astype(np.int32), r_len, r_hash.astype(np.int32))
    got = dc._merge_hashes_device(*(torch.from_numpy(a.astype(np.int64)) for a in (l_len, l_hash, r_len, r_hash)))
    jax_got = jax_dc._merge_hashes_device(
        jnp.asarray(l_len, jnp.int32), jnp.asarray(l_hash.astype(np.int32)),
        jnp.asarray(r_len, jnp.int32), jnp.asarray(r_hash.astype(np.int32)),
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_got).astype(np.int64))


def test_uint32_products_and_wraps_exact():
    """The gapmer arithmetic's uint32 product (in 16-bit halves, no int64
    overflow) and Java's (int) cast, against Python integers."""
    rng = np.random.default_rng(4)
    edge = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.int64)
    a = np.concatenate([np.repeat(edge, edge.size), rng.integers(0, 2**32, 300)])
    b = np.concatenate([np.tile(edge, edge.size), rng.integers(0, 2**32, 300)])
    got = dc._mulmod32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.tolist() == [(int(x) * int(y)) % 2**32 for x, y in zip(a, b)]
    wide = np.array([0, 2**31 - 1, 2**31, 2**32 - 1, 2**32, -1, -(2**31), -(2**31) - 1, 2**40 + 5], dtype=np.int64)
    want = [((int(v) + 2**31) % 2**32) - 2**31 for v in wide]
    assert dc._wrap32(torch.from_numpy(wide)).tolist() == want


# ---------------------------------------------------------------------------
# the candidates program against the host pass and the JAX program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(wl.WORKLOADS))
def workload(request):
    contigs, reads = wl.build(request.param)
    return request.param, Api.new_database(contigs), mapper_tpu.Api.new_database(contigs), reads


def _batches(reads):
    return (ReadBatch.from_sequences([Sequence.from_text(n, t) for n, t in reads]),
            JaxReadBatch.from_sequences([JaxSequence.from_text(n, t) for n, t in reads]))


def _columns(table, skip=()):
    keep = ~np.isin(table.read_id, list(skip)) if len(skip) else np.ones(len(table), bool)
    return [np.asarray(c)[keep] for c in (table.read_id, table.reversed_, table.ref_seq_index,
                                          table.offset, table.votes)]


def test_candidates_match_host_and_jax(workload):
    """The same rows (read, strand, contig, offset, votes, in order) as the
    JAX program on every read, the same fallback ids, and the host pass's
    rows on every read not flagged for fallback."""
    name, index, jax_index, reads = workload
    batch, jax_batch = _batches(reads)
    got = dc.generate_candidates_device(batch, index.hashblock_database, CPU)
    want_jax = jax_dc.generate_candidates_device(jax_batch, jax_index.hashblock_database)
    assert got is not None and want_jax is not None
    table, fallback = got
    np.testing.assert_array_equal(fallback, want_jax[1])
    for g, w in zip(_columns(table), _columns(want_jax[0])):
        np.testing.assert_array_equal(g, w)
    host = generate_candidates(batch, index.hashblock_database)
    for g, w in zip(_columns(table, fallback), _columns(host, fallback)):
        np.testing.assert_array_equal(g, w)
    assert len(table) >= len(reads) - len(fallback)
    if name == "single_contig":
        assert len(fallback) == 0
    elif name == "multi_contig":
        # budget overflows may legitimately defer a few reads
        assert len(fallback) <= 2


def test_candidates_program_shape_and_declines(workload):
    """The raw program output is [B, 2K+1] int32 with empty ranks at the
    sentinel key; an empty batch is declined."""
    _, index, _, reads = workload
    batch, _ = _batches(reads[:8])
    inputs = dc.program_inputs(batch, index.hashblock_database, CPU)
    out = dc.candidates_program(inputs, k_out=5)
    assert out.dtype == torch.int32 and tuple(out.shape) == (min(8, len(reads)), 11)
    keys, votes = out[:, :5], out[:, 5:10]
    assert bool(((votes == 0) == (keys == dc._NO_KEY)).all())
    assert bool((votes[:, :-1] >= votes[:, 1:]).all())  # vote-ranked
    empty = ReadBatch.from_sequences([])
    assert dc.generate_candidates_device(empty, index.hashblock_database, CPU) is None


def test_index_arrays_cached_per_device(workload):
    _, index, _, _ = workload
    db = index.hashblock_database
    first = dc.device_index_arrays(db, CPU)
    assert dc.device_index_arrays(db, "cpu") is first
    assert first["values"].dtype == torch.int32 and first["seq_starts"].dtype == torch.int64
    merged = db.merged_index()
    np.testing.assert_array_equal(first["values"].numpy(), merged["values"])
    np.testing.assert_array_equal(first["counts"].numpy(), merged["counts"])


def _jax_table(jax_batch, jax_db, k_out=8):
    """The JAX program's raw [B, 2K+1] int32 table (`_device_candidates_jit`)."""
    out, _ = jax_dc.generate_candidates_device(jax_batch, jax_db, max_candidates_per_read=k_out, stacked=True)
    return np.asarray(out)


@pytest.mark.parametrize("k_out", [8, 3])
def test_candidates_plain_table_equals_jax(workload, k_out):
    """candidates_plain's [B, 2K+1] int32 table (KC1's plain version) equals
    the JAX program's word for word: keys, votes and fallback flags."""
    _, index, jax_index, reads = workload
    batch, jax_batch = _batches(reads)
    got = dc.candidates_plain(dc.program_inputs(batch, index.hashblock_database, CPU), k_out)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_table(jax_batch, jax_index.hashblock_database, k_out))


def _pyramid_flags(inputs):
    """Per read, from the plain program's first half: whether blocks are
    left that the host path would keep merging after NUM_LEVELS levels, and
    the number of seeds that pass the size filter."""
    seeds = dc._plain_seeds(inputs)
    return seeds["unconverged"].numpy(), seeds["seeds"].numpy()


@pytest.fixture(scope="module")
def fallback_case():
    contigs, reads = wl.build("fallback_reasons")
    index, jax_index = Api.new_database(contigs), mapper_tpu.Api.new_database(contigs)
    batch, jax_batch = _batches(reads)
    inputs = dc.program_inputs(batch, index.hashblock_database, CPU)
    table = dc.candidates_plain(inputs).numpy()
    return [n for n, _ in reads], inputs, table, _jax_table(jax_batch, jax_index.hashblock_database)


def test_each_fallback_flag_is_set_as_in_jax(fallback_case):
    """One read sets each of the three flags alone: blocks left unmerged
    after NUM_LEVELS levels; more than V_SLOTS seeds; more than P_SLOTS vote
    entries (the reads of a ten-fold repeat, which set neither other flag).
    The table equals the JAX program's."""
    names, inputs, table, jax_table = fallback_case
    np.testing.assert_array_equal(table, jax_table)
    unconverged, seeds = _pyramid_flags(inputs)
    flagged = table[:, -1] == 1
    u = names.index(wl.UNCONVERGED)
    assert flagged[u] and unconverged[u] and seeds[u] <= dc.V_SLOTS
    s = names.index(wl.SEED_OVERFLOW)
    assert flagged[s] and not unconverged[s] and seeds[s] > dc.V_SLOTS
    for name in wl.ENTRY_OVERFLOW:
        e = names.index(name)
        assert flagged[e] and not unconverged[e] and seeds[e] <= dc.V_SLOTS, name
    clean = [i for i, n in enumerate(names) if n.startswith(("r", "per"))]
    assert not flagged[clean].any()


def test_top_k_ties_broken_by_key(fallback_case):
    """Ranks of equal votes list their keys ascending, as the JAX program
    does: the repeat's reads tie at their top votes, the periodic reads at
    one vote."""
    names, _, table, jax_table = fallback_case
    np.testing.assert_array_equal(table, jax_table)
    keys, votes = table[:, :8].astype(np.int64), table[:, 8:16]
    ties = (votes[:, :-1] == votes[:, 1:]) & (votes[:, 1:] > 0)
    assert (keys[:, :-1][ties] < keys[:, 1:][ties]).all()
    for name in (*wl.ENTRY_OVERFLOW, "per0"):
        assert ties[names.index(name), 0], name


def test_score_budget_overflow_sets_fallback():
    """fused_rows_plain (KC2's plain version) on 140 reads that keep 8 rows
    each: the kept rows pass score_rows' 1,024, the reads of the rows past
    it take the fallback flag, and the rows are the first 1,024 kept ones in
    read-major, rank-minor order with the geometry the host replays."""
    contigs, reads = wl.build("score_budget")
    index = Api.new_database(contigs)
    batch, _ = _batches(reads)
    params = AlignmentParameters.defaults()
    band, shift = single_end_band(batch.lengths, params, 64)
    concat = BatchAligner(index, params, CPU)._concat_device()
    inputs = dc.fused_inputs(batch, index.hashblock_database, concat, shift, band)
    table = dc.candidates_plain(inputs)
    out_table, read_id, reversed_, win_start, lane, n, m = dc.fused_rows_plain(table, inputs, band)
    c_slots = dc.score_rows(batch.num_reads)
    votes = table[:, 8:16].long()
    keep = (votes > 0) & ((votes[:, :1] < 6) | (votes * 3 >= votes[:, :1]))
    kept_read = torch.nonzero(keep)[:, 0]
    assert len(kept_read) > c_slots == len(read_id)
    past = torch.zeros(batch.num_reads, dtype=torch.bool)
    past[kept_read[c_slots:]] = True
    assert bool(past.any())
    np.testing.assert_array_equal(out_table[:, -1].numpy(), (table[:, -1].bool() | past).int().numpy())
    np.testing.assert_array_equal(out_table[:, :-1].numpy(), table[:, :-1].numpy())
    np.testing.assert_array_equal(read_id.numpy(), kept_read[:c_slots].numpy())
    assert read_id.dtype == win_start.dtype == lane.dtype == torch.int64 and reversed_.dtype == torch.bool
    assert n.dtype == m.dtype == torch.int32
    assert bool(((lane >= 0) & (lane < band)).all()) and bool((m >= 1).all())
    np.testing.assert_array_equal(n.numpy(), batch.lengths[read_id.numpy()])


def test_candidates_programs_refuse_other_devices():
    """A device neither CPU nor CUDA raises in both dispatchers."""
    inputs = {"codes": torch.zeros((1, 64), dtype=torch.uint8, device="meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        dc.candidates_program(inputs)
    with pytest.raises(ValueError, match="unsupported device"):
        dc.fused_rows(torch.zeros((1, 17), dtype=torch.int32, device="meta"), inputs, 64)


# ---------------------------------------------------------------------------
# the fused program against the JAX fused program
# ---------------------------------------------------------------------------


def test_fused_output_matches_jax(workload):
    """The fused program's int32 table equals the JAX fused program's, and
    its scores agree within the scorer tolerances, row for row."""
    name, index, jax_index, reads = workload
    batch, jax_batch = _batches(reads)
    params = AlignmentParameters.defaults()
    band, shift = single_end_band(batch.lengths, params, 64)
    engine = BatchAligner(index, params, CPU)
    got = dc.fused_candidates_scores(batch, index.hashblock_database, engine._concat_device(), params, shift, band)
    jax_engine = JaxBatchAligner(jax_index, mapper_tpu.AlignmentParameters.defaults())
    want = jax_dc.fused_candidates_scores(
        jax_batch, jax_index.hashblock_database, jax_engine._concat_device(),
        mapper_tpu.AlignmentParameters.defaults(), shift, band, use_pallas=False,
    )
    out, finish = got
    want_out = np.asarray(want[0])
    b, k = batch.num_reads, 8
    n_table = b * (2 * k + 1)
    assert out.dtype == torch.int32 and out.shape[0] == want_out.shape[0] == n_table + 2 * dc.score_rows(b)
    np.testing.assert_array_equal(out[:n_table].numpy(), want_out[:n_table])
    scores = out[n_table:].numpy().view(np.float32).reshape(2, -1)
    want_scores = want_out[n_table:].view(np.float32).reshape(2, -1)
    np.testing.assert_allclose(scores[0], want_scores[0], rtol=0, atol=BANDED_ATOL)
    np.testing.assert_allclose(scores[1], want_scores[1], rtol=0, atol=UNGAPPED_ATOL)

    table, fallback, banded, ungapped = finish()
    jax_table, jax_fallback, jax_banded, jax_ungapped = want[1](want[0])
    np.testing.assert_array_equal(fallback, jax_fallback)
    for g, w in zip(_columns(table), _columns(jax_table)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(banded, jax_banded, rtol=0, atol=BANDED_ATOL)
    np.testing.assert_allclose(ungapped, jax_ungapped, rtol=0, atol=UNGAPPED_ATOL)
    scored = np.isfinite(banded) & (banded < 1e8)
    assert scored.mean() > 0.5


# ---------------------------------------------------------------------------
# the fused engine
# ---------------------------------------------------------------------------


def _summarize(result):
    if result is None:
        return None
    out = []
    for choice in result.get_first_alignments():
        comp = choice.get_component(0)
        out.append((
            comp.get_sequence_b().name, comp.get_start_index_b(), comp.is_reference_reversed(),
            round(choice.get_penalty(), 6),
            tuple((s.start_a, s.start_b, s.length_a, s.length_b) for s in comp.sections),
        ))
    return sorted(out)


def _parity_workload():
    """tests/test_device_candidates.py's test_fused_engine_parity_cpu reads."""
    rng = np.random.default_rng(21)
    ref = wl.random_text(rng, 80_000)
    contigs = {"c1": ref[:50_000], "c2": ref[50_000:]}
    reads = wl.random_reads(rng, ref[:50_000], 48) + wl.random_reads(rng, ref[50_000:], 24)
    # an indel read and an unalignable read exercise fallback routing
    indel = list(ref[100:250])
    del indel[60:63]
    reads.append(("indel", "".join(indel)))
    reads.append(("junk", "ACGT" * 37 + "AC"))
    return contigs, reads


def _agreement_workload():
    """tests/test_engine_agreement.py's randomized reads: SNPs, indels,
    reverse strand, ambiguous bases, unalignable reads."""
    rng = np.random.default_rng(777)
    ref = "".join(rng.choice(list("ACGT"), size=30000))
    contigs = {"chrA": ref[:18000], "chrB": ref[18000:]}
    reads = []
    for i in range(60):
        contig_start = 0 if rng.random() < 0.6 else 18000
        contig_len = 18000 if contig_start == 0 else 12000
        pos = int(rng.integers(0, contig_len - 200))
        length = int(rng.integers(120, 180))
        read = list(ref[contig_start + pos : contig_start + pos + length])
        kind = rng.random()
        if kind < 0.5:
            for _ in range(int(rng.integers(0, 3))):
                j = int(rng.integers(0, len(read)))
                read[j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[read[j]]
        elif kind < 0.65:
            j = int(rng.integers(10, len(read) - 10))
            del read[j : j + int(rng.integers(1, 3))]
        elif kind < 0.75:
            j = int(rng.integers(10, len(read) - 10))
            read.insert(j, str(rng.choice(list("ACGT"))))
        elif kind < 0.85:
            j = int(rng.integers(0, len(read)))
            read[j] = "N"
        else:
            read = list("".join(rng.choice(list("ACGT"), size=length)))  # unalignable
        text = "".join(read)
        if rng.random() < 0.5:
            text = basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))
        reads.append((f"r{i}", text))
    return contigs, reads


@pytest.mark.parametrize("make", [_parity_workload, _agreement_workload], ids=["parity", "agreement_fuzz"])
def test_fused_engine_matches_host_and_jax_fused(make):
    """The port's engine on the fused path gives the port's host path's
    results and the JAX engine's on its fused path, read for read; every
    chunk took the fused path."""
    contigs, reads = make()
    index = Api.new_database(contigs)
    jax_index = mapper_tpu.Api.new_database(contigs)
    params = AlignmentParameters.defaults()
    queries = [Query(Sequence.from_text(n, t)) for n, t in reads]
    host = BatchAligner(index, params, CPU, device_candidates=False).process_batch(queries)
    engine = BatchAligner(index, params, CPU, device_candidates=True)
    fused = engine.process_batch([Query(Sequence.from_text(n, t)) for n, t in reads])
    jax_fused = JaxBatchAligner(jax_index, mapper_tpu.AlignmentParameters.defaults(), device_candidates=True
                                ).process_batch([JaxQuery(JaxSequence.from_text(n, t)) for n, t in reads])
    assert engine.stats_fused_chunks == engine.stats_single_end_chunks >= 1
    for i, (h, f, j) in enumerate(zip(host, fused, jax_fused)):
        assert _summarize(f) == _summarize(h) == _summarize(j), (i, reads[i][0])
    assert sum(1 for r in fused if r is not None and any(r.get_alignments())) >= 0.7 * len(reads)
