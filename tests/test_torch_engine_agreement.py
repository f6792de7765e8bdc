"""The agreement fuzz of tests/test_engine_agreement.py on the port: the
port's batch engine against the port's sequential worker (the exact
reference) and against the JAX package's batch engine, on the same
randomized reads, scored by the kernel's plain version on the CPU, twice:
each workload as one chunk (the engine's default chunk of 4,096 reads),
and through the pipeline in chunks of 32 reads (`_run_pipelined`; 79
chunks of the 2,500-read fuzz, past PIPELINE_DEPTH).  Every summarized
alignment set must match.  The worker's and the JAX engine's answers are
computed once per workload."""

import numpy as np
import pytest
import torch

import mapper_tpu
from mapper_tpu.align.query import Query as JaxQuery
from mapper_tpu.batch.engine import BatchAligner as JaxBatchAligner
from mapper_tpu.sequence import Sequence as JaxSequence
from mapper_tpu_torch import Api, AlignmentParameters, basepairs
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.align.worker import AlignerWorker
from mapper_tpu_torch.batch.engine import BatchAligner
from mapper_tpu_torch.sequence import Sequence

CPU = torch.device("cpu")
MODES = ["one_chunk", "pipelined"]
CHUNK_READS = {"one_chunk": 4096, "pipelined": 32}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def engine_mode(request):
    """The engine's pipeline_chunk_reads for the mode."""
    return CHUNK_READS[request.param]


_EXPECTED: dict = {}


def jax_queries(queries):
    """The port's queries as the JAX package's, sequence by sequence."""
    return [
        JaxQuery(
            [JaxSequence.from_text(seq.name, seq.get_text()) for seq in q.get_sequences()],
            expected_inner_distance=q.get_expected_inner_distance(),
            spacing_deviation_per_unit_penalty=q.get_spacing_deviation_per_unit_penalty(),
        )
        for q in queries
    ]


def expected(key, contigs, index, params, queries, summarize):
    """The port's sequential worker's summaries of `queries` and the JAX
    package's batch engine's on the same reference (cached by `key`)."""
    if key not in _EXPECTED:
        worker = AlignerWorker(index, params)
        jax_engine = JaxBatchAligner(
            mapper_tpu.Api.new_database(contigs), mapper_tpu.AlignmentParameters.defaults()
        )
        _EXPECTED[key] = (
            [summarize(worker.align(q)) for q in queries],
            [summarize(r) for r in jax_engine.process_batch(jax_queries(queries))],
        )
    return _EXPECTED[key]


def random_text(n, rng):
    return "".join(rng.choice(list("ACGT"), size=n))


def rc_text(text):
    return basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))


def summarize(result):
    out = []
    for choice in result.get_first_alignments():
        comp = choice.get_component(0)
        out.append(
            (
                comp.get_sequence_b().name,
                comp.get_start_index_b(),
                comp.is_reference_reversed(),
                round(choice.get_penalty(), 6),
                tuple((s.start_a, s.start_b, s.length_a, s.length_b) for s in comp.sections),
            )
        )
    return sorted(out)


def summarize_pair(result):
    rows = []
    for alist in result.get_alignments():
        rows.append(
            tuple(
                sorted(
                    (
                        round(a.get_penalty(), 9),
                        a.spacing_penalty,
                        tuple(
                            (c.get_sequence_b().name, *c.content_key()[1:])
                            for c in a.get_components()
                        ),
                    )
                    for a in alist
                )
            )
        )
    return tuple(rows)


def _agree(key, contigs, reads_or_queries, chunk_reads, summarizer=summarize):
    """The port's batch engine on `contigs`, in chunks of `chunk_reads`
    reads, gives every query the summary of the port's worker and of the
    JAX package's batch engine."""
    params = AlignmentParameters.defaults()
    index = Api.new_database(contigs)
    queries = [q if isinstance(q, Query) else Query(q) for q in reads_or_queries]
    want, jax_want = expected(key, contigs, index, params, queries, summarizer)
    got = BatchAligner(index, params, CPU, pipeline_chunk_reads=chunk_reads).process_batch(list(queries))
    assert len(got) == len(want) == len(jax_want)
    mismatches = [
        (i, summarizer(g), w, j)
        for i, (g, w, j) in enumerate(zip(got, want, jax_want))
        if not summarizer(g) == w == j
    ]
    assert not mismatches, (len(mismatches), mismatches[:3])
    return got


@pytest.mark.parametrize("engine_mode", MODES, indirect=True)
def test_randomized_engine_agreement(engine_mode):
    """Mirrors test_engine_agreement.py::test_randomized_engine_agreement."""
    rng = np.random.default_rng(777)
    ref_text = random_text(30000, rng)
    contigs = {"chrA": ref_text[:18000], "chrB": ref_text[18000:]}
    reads = []
    for i in range(60):
        contig_start = 0 if rng.random() < 0.6 else 18000
        contig_len = 18000 if contig_start == 0 else 12000
        pos = int(rng.integers(0, contig_len - 200))
        length = int(rng.integers(120, 180))
        read = list(ref_text[contig_start + pos : contig_start + pos + length])
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
            read[int(rng.integers(0, len(read)))] = "N"
        else:
            read = list(random_text(length, rng))  # unalignable
        text = "".join(read)
        if rng.random() < 0.5:
            text = rc_text(text)
        reads.append(Sequence.from_text(f"r{i}", text))
    _agree("randomized", contigs, reads, engine_mode)


@pytest.mark.parametrize("engine_mode", MODES, indirect=True)
def test_wide_band_indel_read_matches_exact_engine(engine_mode):
    """Mirrors the JAX test of the same name: a 400 bp read with a 70 bp
    deletion beyond the band must defer to the exact worker, which finds the
    deletion, not the viable ungapped placement."""
    rng = np.random.default_rng(31)
    ref_list = list(random_text(4000, rng))
    ref_list[447:500] = list(ref_list[517:570])
    for j in rng.choice(53, size=39, replace=False):
        ref_list[447 + j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[ref_list[447 + j]]
    ref_text = "".join(ref_list)
    read_text = ref_text[100:447] + ref_text[517:570]
    (batch,) = _agree("wide_band", {"chr": ref_text}, [Sequence.from_text("wide", read_text)], engine_mode)
    assert any(
        any(s.length_a != s.length_b for s in choice.get_component(0).sections)
        for choice in batch.get_first_alignments()
    )


@pytest.mark.parametrize("engine_mode", MODES, indirect=True)
def test_long_read_agreement(engine_mode):
    """Mirrors test_engine_agreement.py::test_long_read_agreement: 1,400 bp
    reads (the split-query regime) on the f32 scorer."""
    rng = np.random.default_rng(99)
    ref_text = random_text(60000, rng)
    reads = []
    for i in range(24):
        pos = int(rng.integers(0, 60000 - 1500))
        text = list(ref_text[pos : pos + 1400])
        kind = i % 4
        if kind == 0:
            for j in rng.choice(1400, size=12, replace=False):
                text[j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[text[j]]
        elif kind == 1:
            text = list(ref_text[pos : pos + 700]) + list(ref_text[pos + 740 : pos + 1440])
        elif kind == 2:
            for j in range(1300, 1400):
                if rng.random() < 0.6:
                    text[j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[text[j]]
        else:
            text = list(random_text(1400, rng))
        s = "".join(text)
        if rng.random() < 0.5:
            s = rc_text(s)
        reads.append(Sequence.from_text(f"L{i}", s))
    _agree("long", {"chr": ref_text}, reads, engine_mode)


@pytest.mark.parametrize("engine_mode", MODES, indirect=True)
def test_agreement_fuzz_large(engine_mode):
    """Mirrors test_engine_agreement.py::test_agreement_fuzz_large at the
    same 2,500 reads: SNPs, indels, N bases, heavy error, junk, both
    strands."""
    n_reads = 2500
    rng = np.random.default_rng(20260820)
    ref_text = random_text(60000, rng)
    contigs = {"f1": ref_text[:35000], "f2": ref_text[35000:]}
    reads = []
    for i in range(n_reads):
        if rng.random() < 0.6:
            contig_start, contig_len = 0, 35000
        else:
            contig_start, contig_len = 35000, 25000
        length = int(rng.integers(100, 190))
        pos = int(rng.integers(0, contig_len - length - 20))
        read = list(ref_text[contig_start + pos : contig_start + pos + length + 10])
        kind = rng.random()
        if kind < 0.45:
            for _ in range(int(rng.integers(0, 7))):
                read[int(rng.integers(0, len(read)))] = "ACGT"[int(rng.integers(0, 4))]
        elif kind < 0.70:
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(10, len(read) - 12))
                if rng.random() < 0.5:
                    del read[j : j + int(rng.integers(1, 4))]
                else:
                    for _k in range(int(rng.integers(1, 4))):
                        read.insert(j, "ACGT"[int(rng.integers(0, 4))])
        elif kind < 0.80:
            read[int(rng.integers(0, len(read)))] = "N"
            for _ in range(int(rng.integers(0, 3))):
                read[int(rng.integers(0, len(read)))] = "ACGT"[int(rng.integers(0, 4))]
        elif kind < 0.90:
            for _ in range(int(rng.integers(8, 15))):
                read[int(rng.integers(0, len(read)))] = "ACGT"[int(rng.integers(0, 4))]
        else:
            read = list(random_text(length, rng))
        text = "".join(read[:length])
        if rng.random() < 0.5:
            text = rc_text(text)
        reads.append(Sequence.from_text(f"z{i}", text))
    _agree("fuzz_large", contigs, reads, engine_mode)


def _port_pairs(jax_queries):
    """The JAX helper's simulated pairs as the port's queries."""
    return [
        Query(
            Sequence.from_text(q.get_sequence(0).name, q.get_sequence(0).get_text()),
            Sequence.from_text(q.get_sequence(1).name, q.get_sequence(1).get_text()),
            expected_inner_distance=q.get_expected_inner_distance(),
            spacing_deviation_per_unit_penalty=q.get_spacing_deviation_per_unit_penalty(),
        )
        for q in jax_queries
    ]


@pytest.mark.parametrize("engine_mode", MODES, indirect=True)
def test_paired_engine_agreement_fuzz(engine_mode):
    """Mirrors test_engine_agreement.py::test_paired_engine_agreement_fuzz."""
    from tests.test_paired_batch import simulate_pairs

    rng = np.random.default_rng(4242)
    ref_text = random_text(40000, rng)
    queries = _port_pairs(simulate_pairs(ref_text[:26000], 200, seed=97))
    _agree("paired", {"pA": ref_text[:26000], "pB": ref_text[26000:]}, queries, engine_mode, summarize_pair)


@pytest.mark.parametrize("engine_mode", MODES, indirect=True)
def test_paired_engine_agreement_fuzz_hard(engine_mode):
    """Mirrors test_engine_agreement.py::test_paired_engine_agreement_fuzz_hard:
    160 pairs of the bench_hard_pe error model on a 150 kb reference."""
    import benchmarks.bench_hard_pe as hpe

    old = (hpe.NUM_PAIRS, hpe.REFERENCE_SIZE)
    hpe.NUM_PAIRS, hpe.REFERENCE_SIZE = 160, 150_000
    try:
        ref_text, pairs = hpe.simulate(seed=1203)
    finally:
        hpe.NUM_PAIRS, hpe.REFERENCE_SIZE = old
    queries = [
        Query(
            Sequence.from_text(a.name, a.get_text()), Sequence.from_text(b.name, b.get_text()),
            expected_inner_distance=100, spacing_deviation_per_unit_penalty=50,
        )
        for a, b in pairs
    ]
    _agree("paired_hard", {"chr1": ref_text}, queries, engine_mode, summarize_pair)


@pytest.mark.parametrize("engine_mode", MODES, indirect=True)
def test_paired_mate_spends_pair_budget(engine_mode):
    """Mirrors test_engine_agreement.py::test_paired_mate_spends_pair_budget:
    one mate over its own budget (a 3 bp deletion and 13 SNPs, 16.3 > 15)
    but within the pair budget (30) must align as the worker aligns it: the
    mates' windows span the pair's budget."""
    rng = np.random.default_rng(17)
    bases = "ACGT"
    ref_text = "".join(bases[int(b)] for b in rng.integers(0, 4, size=20000))
    queries = []
    for i in range(8):
        pos, inner = 1000 + 1700 * i, 100
        frag = 300 + inner
        m1 = ref_text[pos : pos + 150]
        m2 = list(ref_text[pos + frag - 153 : pos + frag])
        del m2[75:78]
        for j in list(range(3, 70, 6)) + list(range(85, 95, 6)):
            m2[j] = bases[(bases.index(m2[j]) + 1) % 4]
        queries.append(Query(
            [Sequence.from_text(f"b{i}/1", m1), Sequence.from_text(f"b{i}/2", rc_text("".join(m2)))],
            expected_inner_distance=inner, spacing_deviation_per_unit_penalty=50,
        ))
    got = _agree("pair_budget", {"chr1": ref_text}, queries, engine_mode, summarize_pair)
    assert all(any(r.get_alignments()) for r in got)
