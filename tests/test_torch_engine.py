"""The port's BatchAligner on `torch.device("cpu")` against `mapper_tpu`'s
BatchAligner on one index: SamWriter output byte-identical.  Short reads take
the int16 scorer, reads over 512 bp the f32 one (the plain PyTorch versions
of the CUDA kernels on the CPU)."""

import io
import sys
import threading

import numpy as np
import pytest
import torch

from benchmarks.simlib import random_reference, rc_text
from mapper_tpu import Api, AlignmentParameters
from mapper_tpu.align.query import Query
from mapper_tpu.batch.engine import BatchAligner as JaxBatchAligner
from mapper_tpu.io.sam import SamWriter
from mapper_tpu.sequence import Sequence
from mapper_tpu_torch.align import banded
from mapper_tpu_torch.batch import engine as torch_engine
from mapper_tpu_torch.batch.engine import BatchAligner, upload_reference
from mapper_tpu_torch.simulate import simulate_reads

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(2024)
    ref = random_reference(rng, 50_000)
    index = Api.new_database({"chrA": ref[:30_000], "chrB": ref[30_000:]})
    short = simulate_reads(rng, ref, 512, 150, snp_rate=0.01, indel_fraction=0.2)
    long_ = simulate_reads(rng, ref, 6, 700, prefix="L")
    return ref, index, short, long_


def _queries(reads):
    return [Query(Sequence.from_text(name, text)) for name, text in reads]


def _sam(index, results, paired=False):
    stream = io.StringIO()
    seq_db = index.hashblock_database.get_sequence_database()
    SamWriter(seq_db, stream, paired).add_alignments(results)
    return stream.getvalue()


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


@pytest.mark.parametrize("kind", ["short", "long"])
def test_engine_sam_matches_jax_engine(workload, scorer_calls, kind):
    _, index, short, long_ = workload
    reads = short if kind == "short" else long_
    params = AlignmentParameters.defaults()
    want = JaxBatchAligner(index, params).process_batch(_queries(reads))
    engine = BatchAligner(index, params, CPU)
    got = engine.process_batch(_queries(reads))
    sam = _sam(index, got)
    assert sam == _sam(index, want)
    assert sum(1 for r in got if r is not None and any(r.get_alignments())) >= 0.95 * len(reads)
    # the kernel's plain version scored the chunk, on the int16 path for
    # 150 bp and the f32 path above 512 bp
    assert scorer_calls and all(q == (kind == "short") for _, q in scorer_calls)


def test_host_scoring_switch_matches(workload, monkeypatch, scorer_calls):
    _, index, short, _ = workload
    params = AlignmentParameters.defaults()
    reads = short[:128]
    kernel = _sam(index, BatchAligner(index, params, CPU).process_batch(_queries(reads)))
    n_kernel = len(scorer_calls)
    monkeypatch.setenv("MAPPER_TPU_HOST_SCORING", "1")
    host = _sam(index, BatchAligner(index, params, CPU).process_batch(_queries(reads)))
    assert host == kernel
    assert n_kernel >= 1 and len(scorer_calls) == n_kernel  # no scorer call


def test_host_scoring_long_reads_matches(workload, monkeypatch, scorer_calls):
    """With the host-scoring ceiling raised above the read length, reads over
    512 bp are scored by the native DP too, with the f32 scorer's SAM."""
    _, index, _, long_ = workload
    params = AlignmentParameters.defaults()
    kernel = _sam(index, BatchAligner(index, params, CPU).process_batch(_queries(long_)))
    n_kernel = len(scorer_calls)
    monkeypatch.setenv("MAPPER_TPU_HOST_SCORING", "1")
    monkeypatch.setattr(torch_engine, "HOST_SCORING_MAX_LEN", 1024)
    host = _sam(index, BatchAligner(index, params, CPU).process_batch(_queries(long_)))
    assert host == kernel
    assert n_kernel >= 1 and len(scorer_calls) == n_kernel  # no scorer call


def test_paired_engine_matches_jax_engine(workload):
    ref, index, _, _ = workload
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

    def make():
        return [
            Query(Sequence.from_text(a, x), Sequence.from_text(b, y),
                  expected_inner_distance=100, spacing_deviation_per_unit_penalty=50)
            for a, x, b, y in queries
        ]

    params = AlignmentParameters.defaults()
    want = JaxBatchAligner(index, params).process_batch(make())
    got = BatchAligner(index, params, CPU).process_batch(make())
    assert _sam(index, got, paired=True) == _sam(index, want, paired=True)


def test_concurrent_batches_share_one_engine(workload):
    """process_batch from several threads against one engine (as the CLI's
    pool runs it): the results and the fallback-reason counts match serial
    runs, and the reference is uploaded once."""
    _, index, short, _ = workload
    params = AlignmentParameters.defaults()
    chunks = [short[i * 64 : (i + 1) * 64] for i in range(4)]
    serial = BatchAligner(index, params, CPU)
    want = [_sam(index, serial.process_batch(_queries(c))) for c in chunks]

    engine = BatchAligner(index, params, CPU)
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


def test_upload_reference(workload):
    _, index, _, _ = workload
    concat = index.hashblock_database.get_sequence_database().concatenated_codes()
    t = upload_reference(concat, CPU)
    assert t.dtype == torch.uint8 and t.device == CPU
    assert np.array_equal(t.numpy(), concat)


@pytest.mark.parametrize(
    "kwargs,env",
    [
        ({"mesh": object()}, {}),
        ({"device_candidates": True}, {}),
        ({}, {"MAPPER_TPU_DEVICE_CANDIDATES": "1"}),
    ],
)
def test_unported_options_raise(workload, monkeypatch, kwargs, env):
    _, index, _, _ = workload
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError):
        BatchAligner(index, AlignmentParameters.defaults(), CPU, **kwargs)


def test_device_pileup_raises_if_set(workload):
    """The device pileup is ported: none by default; once set, the engine
    counts the same reads on it as the JAX engine on its own, and the
    merged pileups are equal.  The name is the one this test had when the
    engine refused the device pileup; it is kept so the test's record
    carries on."""
    from mapper_tpu.batch.device_pileup import DevicePileup as JaxDevicePileup
    from mapper_tpu.pileup import MatchDatabase
    from mapper_tpu_torch.batch.device_pileup import DevicePileup

    _, index, short, _ = workload
    params = AlignmentParameters.defaults()
    seq_db = index.hashblock_database.get_sequence_database()
    engine = BatchAligner(index, params, CPU)
    assert engine.device_pileup is None
    engine.device_pileup = DevicePileup(seq_db, 0.1, CPU)
    jax_engine = JaxBatchAligner(index, params)
    jax_engine.device_pileup = JaxDevicePileup(seq_db, 0.1)
    got = engine.process_batch(_queries(short))
    want = jax_engine.process_batch(_queries(short))
    counted = [getattr(r, "device_counted", False) for r in got]
    assert counted == [getattr(r, "device_counted", False) for r in want]
    assert engine.device_pileup.num_rows_accumulated == sum(counted) > 0.5 * len(short)
    merged = []
    for pileup in (engine.device_pileup, jax_engine.device_pileup):
        db = MatchDatabase(0.1)
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
    from mapper_tpu.align.cache import AlignmentCache
    from mapper_tpu.pileup import MatchDatabase

    _, index, short, _ = workload
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
