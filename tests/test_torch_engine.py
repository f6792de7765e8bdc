"""The port's BatchAligner on `torch.device("cpu")` against `mapper_tpu`'s
BatchAligner, each on its own package's index, queries and parameters built
from the same reference and reads: SamWriter output byte-identical.  Short
reads take the int16 scorer, reads over 512 bp the f32 one (the plain
PyTorch versions of the CUDA kernels on the CPU)."""

import inspect
import io
import os
import sys
import threading

import numpy as np
import pytest
import torch

from benchmarks.simlib import random_reference, rc_text
import mapper_tpu
from mapper_tpu.align.query import Query as JaxQuery
from mapper_tpu.batch.candidates import CandidateTable as JaxCandidateTable, ReadBatch as JaxReadBatch
from mapper_tpu.batch.engine import BatchAligner as JaxBatchAligner
from mapper_tpu.io.sam import SamWriter as JaxSamWriter
from mapper_tpu.sequence import Sequence as JaxSequence
from mapper_tpu_torch import Api, AlignmentParameters
from mapper_tpu_torch.align import banded
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.io.sam import SamWriter
from mapper_tpu_torch.sequence import Sequence
from mapper_tpu_torch.batch import engine as torch_engine
from mapper_tpu_torch.batch.candidates import CandidateTable, ReadBatch
from mapper_tpu_torch.batch.engine import BatchAligner, indel_budget, single_end_band, upload_reference
from mapper_tpu_torch.simulate import simulate_reads

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scorer's many small tensor operations run no faster on
    several threads, and the suite runs in several processes at once, whose
    thread pools would contend for the cores: one intra-op thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(2024)
    ref = random_reference(rng, 50_000)
    contigs = {"chrA": ref[:30_000], "chrB": ref[30_000:]}
    index = Api.new_database(contigs)
    short = simulate_reads(rng, ref, 512, 150, snp_rate=0.01, indel_fraction=0.2)
    long_ = simulate_reads(rng, ref, 6, 700, prefix="L")
    return ref, index, short, long_, mapper_tpu.Api.new_database(contigs)


def _queries(reads):
    return [Query(Sequence.from_text(name, text)) for name, text in reads]


def _jax_queries(reads):
    return [JaxQuery(JaxSequence.from_text(name, text)) for name, text in reads]


def _sam(index, results, paired=False, writer=SamWriter):
    stream = io.StringIO()
    seq_db = index.hashblock_database.get_sequence_database()
    writer(seq_db, stream, paired).add_alignments(results)
    return stream.getvalue()


def _jax_sam(jax_index, results, paired=False):
    return _sam(jax_index, results, paired, JaxSamWriter)


def _jax_params():
    return mapper_tpu.AlignmentParameters.defaults()


@pytest.fixture
def scorer_calls(monkeypatch):
    """Records (read width, quantized?) of every scoring call the engine makes."""
    calls = []
    inner = torch_engine.banded_scores_gathered

    def spy(reads, *args):
        params, band = args[-2], args[-1]
        calls.append((reads.shape[1], banded._quantize_params(params, reads.shape[1], band) is not None))
        return inner(reads, *args)

    monkeypatch.setattr(torch_engine, "banded_scores_gathered", spy)
    return calls


@pytest.mark.parametrize("chunk", [None, 32])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_engine_sam_matches_jax_engine(workload, scorer_calls, kind, chunk):
    """`chunk` is the engine's pipeline_chunk_reads: None scores the batch
    as one chunk, 32 runs it through the pipeline (16 chunks of the short
    reads)."""
    _, index, short, long_, jax_index = workload
    reads = short if kind == "short" else long_
    params = AlignmentParameters.defaults()
    want = JaxBatchAligner(jax_index, _jax_params()).process_batch(_jax_queries(reads))
    engine = BatchAligner(index, params, CPU, pipeline_chunk_reads=chunk)
    got = engine.process_batch(_queries(reads))
    sam = _sam(index, got)
    assert sam == _jax_sam(jax_index, want)
    assert sum(1 for r in got if r is not None and any(r.get_alignments())) >= 0.95 * len(reads)
    # the kernel's plain version scored the chunk, on the int16 path for
    # 150 bp and the f32 path above 512 bp
    assert scorer_calls and all(q == (kind == "short") for _, q in scorer_calls)


def test_paired_engine_matches_jax_engine(workload):
    ref, index, _, _, jax_index = workload
    rng = np.random.default_rng(5)
    queries = []
    for i in range(48):
        pos = int(rng.integers(0, 29_000 - 400))
        frag = list(ref[pos : pos + int(rng.integers(250, 330))])
        for j in rng.integers(0, len(frag), size=2):
            frag[j] = "ACGT"[int(rng.integers(0, 4))]
        if i % 4 == 0:
            del frag[40 : 40 + int(rng.integers(1, 3))]
        frag = "".join(frag)
        queries.append(
            (f"p{i}/1", frag[:100], f"p{i}/2", rc_text(frag[-100:]))
        )

    def make(query=Query, sequence=Sequence):
        return [
            query(sequence.from_text(a, x), sequence.from_text(b, y),
                  expected_inner_distance=100, spacing_deviation_per_unit_penalty=50)
            for a, x, b, y in queries
        ]

    want = JaxBatchAligner(jax_index, _jax_params()).process_batch(make(JaxQuery, JaxSequence))
    got = BatchAligner(index, AlignmentParameters.defaults(), CPU).process_batch(make())
    assert _sam(index, got, paired=True) == _jax_sam(jax_index, want, paired=True)


def _jax_budget(lengths, jp):
    """The JAX engine's indel budget, as its single-end and paired dispatch
    write it out."""
    return np.maximum(
        0,
        ((lengths * jp.max_error_rate - jp.deletion_start_penalty) / jp.deletion_extension_penalty).astype(np.int64),
    )


@pytest.mark.parametrize("case", ["single_band64", "single_band128", "paired"])
def test_window_geometry_and_certificate_match_jax_engine(workload, monkeypatch, case):
    """One candidate table of interior, contig-edge and off-contig rows (and
    rows whose window is empty), on both strands, at each read's origin and
    off it: the port's window geometry (in_contig, at_edge, valid, lane)
    and certified rows equal the JAX engine's `_window_geometry`, the lanes
    its `_dispatch_scores` builds and its certificate's rows.  The
    half-windows are the single-end reads' budgets (150 bp reads take band
    64, 200-400 bp band 128) or, paired, each pair's budget on both mates."""
    ref, index, _, _, jax_index = workload
    contigs = [ref[:30_000], ref[30_000:]]
    rng = np.random.default_rng(["single_band64", "single_band128", "paired"].index(case))
    lo, hi = (200, 400) if case == "single_band128" else (100, 160)
    texts, origins = [], []
    for i in range(12):
        contig = contigs[i % 2]
        n = int(rng.integers(lo, hi))
        pos = [3, len(contig) - n - 2][i % 2] if i in (4, 5) else int(rng.integers(100, len(contig) - n - 100))
        read = list(contig[pos : pos + n])
        for j in rng.integers(0, n, size=i % 4):  # 0-3 SNPs
            read[j] = "ACGT"[("ACGT".index(read[j]) + 1) % 4]
        if i % 6 == 5:
            del read[n // 2 : n // 2 + 2]  # a deletion: no certificate
            read += list(contig[pos + n : pos + n + 2])
        rev = bool(i % 3 == 0)
        texts.append(rc_text("".join(read)) if rev else "".join(read))
        origins.append((pos, rev))
    seqs = [Sequence.from_text(f"r{i}", t) for i, t in enumerate(texts)]
    jax_seqs = [JaxSequence.from_text(f"r{i}", t) for i, t in enumerate(texts)]
    batch, jax_batch = ReadBatch.from_sequences(seqs), JaxReadBatch.from_sequences(jax_seqs)

    p, jp = AlignmentParameters.defaults(), _jax_params()
    if case == "paired":  # components 2i and 2i + 1 are the mates of pair i
        total = batch.lengths[0::2] + batch.lengths[1::2]
        band, _ = single_end_band(total, p)
        shift = np.minimum(np.repeat(indel_budget(total, p), 2), band // 2)
        jax_budget = _jax_budget(total, jp)
        jax_band = 64 if int(jax_budget.max(initial=0)) <= 31 else 128
        jax_shift = np.minimum(np.repeat(jax_budget, 2), jax_band // 2)
    else:
        band, shift = single_end_band(batch.lengths, p)
        jax_budget = _jax_budget(batch.lengths, jp)
        jax_band = 64 if int(jax_budget.max(initial=0)) <= 31 else 128
        jax_shift = np.minimum(jax_budget, jax_band // 2)
    assert band == jax_band == (64 if case == "single_band64" else 128)
    np.testing.assert_array_equal(shift, jax_shift)

    rows = []  # (read, reversed, contig, offset)
    for i, (pos, rev) in enumerate(origins):
        c, n, h, end = i % 2, int(batch.lengths[i]), int(shift[i]), len(contigs[i % 2])
        # at the origin and off it; the window's edge on the contig's and one
        # past it; off the contig; an empty window at either end
        for off in (pos, pos - 2, pos + 2, h, h - 1, end - n - h, end - n - h + 1, 0, end - n, -3, end - n + 3,
                    -n - h, end + h):
            rows.append((i, rev if off == pos else bool(rng.integers(0, 2)), c, off))
    read_id, reversed_, ref_seq_index, offset = (np.array(col) for col in zip(*rows))
    columns = (read_id.astype(np.int32), reversed_.astype(bool), ref_seq_index.astype(np.int32),
               offset.astype(np.int64), np.ones(len(rows), dtype=np.int32))
    table, jax_table = CandidateTable(*columns), JaxCandidateTable(*columns)

    geom, ungapped, skip, dev_rows = BatchAligner(index, p, CPU)._certify(seqs, batch, table, shift)

    jax_engine = JaxBatchAligner(jax_index, jp)
    want = jax_engine._window_geometry(jax_batch, jax_table, jax_shift)
    # the JAX engine's lanes: those its _dispatch_scores hands its host
    # scorer, which it calls with its default settings
    for key in [k for k in os.environ if k.startswith("MAPPER_TPU")]:
        monkeypatch.delenv(key)
    host_scorer = inspect.signature(JaxBatchAligner._dispatch_scores_native)
    seen = {}

    def capture(*args, **kwargs):
        seen.update(host_scorer.bind(jax_engine, *args, **kwargs).arguments)
        return {}

    jax_engine._dispatch_scores_native = capture
    jax_engine._dispatch_scores(jax_seqs, jax_batch, jax_table, jax_shift, jax_band)
    for name in ("in_contig", "at_edge", "valid", "n_per_cand"):
        np.testing.assert_array_equal(geom[name], want[name], err_msg=name)
    for name in ("lane", "win_start_global", "w_len"):
        np.testing.assert_array_equal(geom[name], seen[name], err_msg=name)
    # the JAX engine's certificate
    jax_ungapped = np.full(len(jax_table), np.inf)
    ic_rows = np.nonzero(want["in_contig"])[0]
    jax_ungapped[ic_rows] = jax_engine._ungapped_penalties(jax_seqs, jax_table, ic_rows)
    min_indel = min(
        jp.get_starting_insertion_start_penalty() + jp.insertion_extension_penalty,
        jp.deletion_start_penalty + jp.deletion_extension_penalty,
    )
    jax_skip = want["in_contig"] & ~want["at_edge"] & (jax_ungapped <= min_indel)
    np.testing.assert_array_equal(ungapped, jax_ungapped)
    np.testing.assert_array_equal(skip, jax_skip)
    np.testing.assert_array_equal(dev_rows, np.nonzero(~jax_skip)[0])
    # the table reaches every kind of row, certified rows included
    assert skip.any() and (want["in_contig"] & want["at_edge"]).any()
    assert (~want["in_contig"] & want["valid"]).any() and (~want["valid"]).any()
    assert (geom["in_contig"] & ~geom["at_edge"] & ~skip).any()


def test_concurrent_batches_share_one_engine(workload):
    """process_batch from several threads against one engine (as the CLI's
    pool runs it): the results and the fallback-reason counts match serial
    runs, and the reference is uploaded once."""
    _concurrent_batches(workload)


def test_concurrent_fused_batches_share_one_engine(workload):
    """As above on the fused device-candidates path, which also shares the
    device index cache and the chunk counters between the threads."""
    serial, engine = _concurrent_batches(workload, device_candidates=True)
    assert engine.stats_fused_chunks == engine.stats_single_end_chunks == serial.stats_fused_chunks == 4


def _concurrent_batches(workload, **kwargs):
    _, index, short, _, _ = workload
    params = AlignmentParameters.defaults()
    chunks = [short[i * 64 : (i + 1) * 64] for i in range(4)]
    serial = BatchAligner(index, params, CPU, **kwargs)
    want = [_sam(index, serial.process_batch(_queries(c))) for c in chunks]

    engine = BatchAligner(index, params, CPU, **kwargs)
    got = [None] * len(chunks)
    uploads = []
    real_upload = torch_engine.upload_reference

    def counting_upload(concat, device):
        uploads.append(1)
        return real_upload(concat, device)

    def work(i):
        got[i] = _sam(index, engine.process_batch(_queries(chunks[i])))

    old = sys.getswitchinterval()
    torch_engine.upload_reference = counting_upload
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(chunks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        torch_engine.upload_reference = real_upload
    assert got == want
    assert engine.stats_fallback_reasons == serial.stats_fallback_reasons
    assert len(uploads) == 1
    return serial, engine


def test_upload_reference(workload):
    _, index, _, _, _ = workload
    concat = index.hashblock_database.get_sequence_database().concatenated_codes()
    t = upload_reference(concat, CPU)
    assert t.dtype == torch.uint8 and t.device == CPU
    assert np.array_equal(t.numpy(), concat)


@pytest.mark.parametrize("kwargs,env", [({"mesh": object()}, {})])
def test_unported_options_raise(workload, monkeypatch, kwargs, env):
    """The mesh is ported (tests/test_torch_mesh.py); what is not a mesh of
    devices is refused.  The name is the one this test had when the engine
    refused any mesh; it is kept so the test's record carries on."""
    _, index, _, _, _ = workload
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(TypeError):
        BatchAligner(index, AlignmentParameters.defaults(), CPU, **kwargs)


@pytest.mark.parametrize(
    "kwargs,env",
    [({"device_candidates": True}, {}), ({}, {"MAPPER_TPU_DEVICE_CANDIDATES": "1"})],
    ids=["keyword", "environment"],
)
def test_device_candidates_option_takes_fused_path(workload, monkeypatch, kwargs, env):
    """The keyword and the environment variable each send every single-end
    chunk through the fused device-candidates path, whose SAM equals the
    host path's; without either, no chunk takes it."""
    _, index, short, _, _ = workload
    params = AlignmentParameters.defaults()
    reads = short[:160]
    host_engine = BatchAligner(index, params, CPU)
    host = _sam(index, host_engine.process_batch(_queries(reads)))
    assert host_engine.stats_fused_chunks == 0 < host_engine.stats_single_end_chunks
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    engine = BatchAligner(index, params, CPU, **kwargs)
    assert _sam(index, engine.process_batch(_queries(reads))) == host
    assert engine.stats_fused_chunks == engine.stats_single_end_chunks > 0


def test_device_pileup_raises_if_set(workload):
    """The device pileup is ported: none by default; once set, the engine
    counts the same reads on it as the JAX engine on its own, and the
    merged pileups are equal.  The name is the one this test had when the
    engine refused the device pileup; it is kept so the test's record
    carries on."""
    from mapper_tpu.batch.device_pileup import DevicePileup as JaxDevicePileup
    from mapper_tpu.pileup import MatchDatabase as JaxMatchDatabase
    from mapper_tpu_torch.batch.device_pileup import DevicePileup
    from mapper_tpu_torch.pileup import MatchDatabase

    _, index, short, _, jax_index = workload
    params = AlignmentParameters.defaults()
    seq_db = index.hashblock_database.get_sequence_database()
    engine = BatchAligner(index, params, CPU)
    assert engine.device_pileup is None
    engine.device_pileup = DevicePileup(seq_db, 0.1, CPU)
    jax_engine = JaxBatchAligner(jax_index, _jax_params())
    jax_engine.device_pileup = JaxDevicePileup(jax_index.hashblock_database.get_sequence_database(), 0.1)
    got = engine.process_batch(_queries(short))
    want = jax_engine.process_batch(_jax_queries(short))
    counted = [getattr(r, "device_counted", False) for r in got]
    assert counted == [getattr(r, "device_counted", False) for r in want]
    assert engine.device_pileup.num_rows_accumulated == sum(counted) > 0.5 * len(short)
    merged = []
    for pileup, database in ((engine.device_pileup, MatchDatabase), (jax_engine.device_pileup, JaxMatchDatabase)):
        db = database(0.1)
        pileup.merge_into(db)
        merged.append({seq.name: (p.middle, p.end) for seq, p in db.group_by_position().items()})
    assert merged[0].keys() == merged[1].keys() == {"chrA", "chrB"}
    for name, arrays in merged[0].items():
        for got_a, want_a in zip(arrays, merged[1][name]):
            np.testing.assert_array_equal(got_a, want_a)


def test_cache_hits_replay_the_fresh_alignment(workload):
    """Reads whose content was seen before take the cached alignment: the
    SAM and the pileup of the hits equal those of the same reads aligned
    afresh, on both strands."""
    from mapper_tpu_torch.align.cache import AlignmentCache
    from mapper_tpu_torch.pileup import MatchDatabase

    _, index, short, _, _ = workload
    params = AlignmentParameters.defaults()
    engine = BatchAligner(index, params, CPU)
    engine.cache = AlignmentCache()
    engine.cache.choose_enable_fraction = lambda batch_size: 1.0  # store every result
    engine.process_batch(_queries(short))
    twins = [(f"twin{i}", text) for i, (_, text) in enumerate(short)]
    hits = engine.process_batch(_queries(twins))
    assert engine.fallback_worker.stats.num_cache_hits >= 0.9 * len(short)
    fresh = BatchAligner(index, params, CPU).process_batch(_queries(twins))
    sam = _sam(index, hits)
    assert sam == _sam(index, fresh)
    assert sum(line.split("\t")[1] == "16" for line in sam.splitlines()) > 0.3 * len(short)
    pileups = []
    for results in (hits, fresh):
        db = MatchDatabase(0.1)
        db.add_alignments(results)
        pileups.append({seq.name: (p.middle, p.end) for seq, p in db.group_by_position().items()})
    for name, arrays in pileups[0].items():
        for got, want in zip(arrays, pileups[1][name]):
            np.testing.assert_array_equal(got, want)


def test_exact_engine_cache_hits_keep_the_strand(workload):
    """The sequential worker (`--engine exact`) replays a cache hit with
    `QueryAlignment.with_query`: reverse-strand hits keep the reverse
    complement of the new read, so their SAM and pileup equal those of the
    same reads aligned afresh."""
    from mapper_tpu_torch.align.cache import AlignmentCache
    from mapper_tpu_torch.align.worker import AlignerWorker
    from mapper_tpu_torch.pileup import MatchDatabase

    _, index, short, _, _ = workload
    reads = short[:96]
    params = AlignmentParameters.defaults()
    worker = AlignerWorker(index, params, cache=AlignmentCache())
    worker.cache.choose_enable_fraction = lambda batch_size: 1.0  # store every result
    worker.process_batch(_queries(reads))
    twins = [(f"twin{i}", text) for i, (_, text) in enumerate(reads)]
    hits = worker.process_batch(_queries(twins))
    assert worker.stats.num_cache_hits >= 0.9 * len(reads)
    fresh = AlignerWorker(index, params).process_batch(_queries(twins))
    sam = _sam(index, hits)
    assert sum(line.split("\t")[1] == "16" for line in sam.splitlines()) > 0.3 * len(reads)
    assert sam == _sam(index, fresh)
    pileups = []
    for results in (hits, fresh):
        db = MatchDatabase(0.1)
        db.add_alignments(results)
        pileups.append({seq.name: (p.middle, p.end) for seq, p in db.group_by_position().items()})
    assert pileups[0].keys() == pileups[1].keys()
    for name, arrays in pileups[0].items():
        for got, want in zip(arrays, pileups[1][name]):
            np.testing.assert_array_equal(got, want)
