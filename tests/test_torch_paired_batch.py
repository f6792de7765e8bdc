"""tests/test_paired_batch.py on the port: the port's vectorized paired-end
batch path (`mapper_tpu_torch.batch.engine`, on the CPU with the kernel's
plain version) against the port's own references and the JAX package's
vectorized path on the same queries.

1. The vectorized pairing (_paired_combos) must enumerate exactly the combos,
   in exactly the discovery order, of the reference pairing scan
   (HashBlockPaths_Counter.java:136-247, ported in align/candidates.py's
   PathsCounter._match_without_cache), and of the JAX engine's pairing.
2. The vectorized decision algebra must produce the same final outputs as
   forcing every pair through the exact per-pair QueryMatchAligner path,
   and as the JAX engine's vectorized path.
"""

import numpy as np
import pytest

import torch

import mapper_tpu
from mapper_tpu.batch.candidates import ReadBatch as JaxReadBatch
from mapper_tpu.batch.candidates import generate_candidates as jax_generate_candidates
from mapper_tpu.batch.engine import BatchAligner as JaxBatchAligner
from mapper_tpu_torch import Api, AlignmentParameters, basepairs
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.batch.candidates import ReadBatch, generate_candidates
from mapper_tpu_torch.batch.engine import BatchAligner
from tests.test_torch_engine_agreement import jax_queries


CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_text(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def rc_text(text):
    return basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))


def simulate_pairs(ref_text, num_pairs, seed, read_len=100):
    """Pairs with SNPs, indels, overlapping mates, contig-edge fragments and
    both fragment orientations."""
    rng = np.random.default_rng(seed)
    bases = list("ACGT")
    queries = []
    n = len(ref_text)
    for i in range(num_pairs):
        kind = i % 6
        if kind == 5:  # fragment at a contig edge
            pos = int(rng.integers(0, 3)) if rng.random() < 0.5 else n - 2 * read_len - int(rng.integers(0, 3))
        else:
            pos = int(rng.integers(0, n - 2 * read_len - 60))
        if kind == 3:  # overlapping mates (inner distance < 0)
            frag_len = int(rng.integers(read_len + 10, 2 * read_len - 20))
        else:
            frag_len = int(rng.integers(2 * read_len, 2 * read_len + 60))
        frag_len = min(frag_len, n - pos)
        frag = list(ref_text[pos : pos + frag_len])
        num_snps = int(rng.integers(0, 5))
        for _ in range(num_snps):
            j = int(rng.integers(0, len(frag)))
            frag[j] = bases[int(rng.integers(0, 4))]
        if kind == 4 and len(frag) > 40:  # small indel in mate 1
            j = int(rng.integers(10, 30))
            if rng.random() < 0.5:
                frag.insert(j, bases[int(rng.integers(0, 4))])
            else:
                del frag[j]
        frag = "".join(frag)
        if len(frag) < read_len + 5:
            frag = frag + ref_text[pos + len(frag) : pos + read_len + 5]
        m1 = frag[:read_len]
        m2 = rc_text(frag[-read_len:])
        if rng.random() < 0.5:  # fragment orientation
            m1, m2 = rc_text(frag[-read_len:]), frag[:read_len]
        from mapper_tpu_torch.sequence import Sequence

        queries.append(
            Query(
                Sequence.from_text(f"p{i}/1", m1),
                Sequence.from_text(f"p{i}/2", m2),
                expected_inner_distance=60,
                spacing_deviation_per_unit_penalty=30,
            )
        )
    return queries


def combos_via_pathscounter(engine, queries, components, batch, table):
    """The pre-vectorization pairing: PathsCounter over per-component shims."""
    from mapper_tpu_torch.align.candidates import PathsCounter, SequenceMatch

    p = engine.parameters
    order = np.argsort(table.read_id, kind="stable")
    boundaries = np.searchsorted(table.read_id[order], np.arange(2 * len(queries) + 1))

    class Shim:
        __slots__ = ("match", "priority")

        def __init__(self, match):
            self.match = match
            self.priority = 0

        def get_num_distinct_mismatches(self):
            return 0

    out = []
    for pair_idx, query in enumerate(queries):
        max_interesting = query.get_length() * p.max_error_rate
        max_inner = int(
            max_interesting * query.get_spacing_deviation_per_unit_penalty()
            + query.get_expected_inner_distance()
        )
        counters_per_component = []
        for ci in range(2):
            read_id = 2 * pair_idx + ci
            rows = order[boundaries[read_id] : boundaries[read_id + 1]]
            component_seq = components[read_id]
            shims = []
            for c in rows.tolist():
                ref = engine.seq_db.get_sequence(int(table.ref_seq_index[c]))
                seq_a = (
                    component_seq.reverse_complement()
                    if table.reversed_[c]
                    else component_seq
                )
                shims.append(Shim(SequenceMatch(seq_a, ref, int(table.offset[c]))))
            counters_per_component.append(shims)
        pc = PathsCounter.__new__(PathsCounter)
        pc.components = []
        pc.max_offset_between_components = max_inner + len(query.get_sequence(0))
        pc.found_nonempty_result = True
        pc._prev_components = None
        pc._prev_matches = None
        for qm in pc._match_without_cache(counters_per_component):
            m0, m1 = qm.get_component(0), qm.get_component(1)
            out.append(
                (
                    pair_idx,
                    m0.reversed,
                    id(m0.sequence_b),
                    m0.offset,
                    m1.offset,
                    qm.get_total_distance_between_components(),
                )
            )
    return out


def jax_engine(contigs):
    """The JAX package's batch engine on the same contigs, vectorized pairing."""
    return JaxBatchAligner(
        mapper_tpu.Api.new_database(contigs), mapper_tpu.AlignmentParameters.defaults(),
        paired_vectorized=True,
    )


def named(qa):
    """Each alignment's penalties and components, a component's reference
    named (its `content_key` holds the reference object's identity), for
    the comparison across the two packages."""
    if qa is None:
        return None
    return tuple(
        tuple(
            (
                a.get_penalty(),
                a.spacing_penalty,
                tuple(c.get_penalty() for c in a.get_components()),
                tuple((c.get_sequence_b().name, *c.content_key()[1:]) for c in a.get_components()),
            )
            for a in alist
        )
        for alist in qa.get_alignments()
    )


def assert_same_as_jax(contigs, queries, results):
    want = jax_engine(contigs).process_batch(jax_queries(queries), notify=False)
    assert len(want) == len(results)
    for i, (got, jax_got) in enumerate(zip(results, want)):
        assert named(got) == named(jax_got), f"query {i} diverged from the JAX engine"


def paired_combos(engine, queries, read_batch, generate):
    """The engine's vectorized pairing of `queries`, with the batch and the
    candidate table it paired."""
    components = []
    for query in queries:
        components.append(query.get_sequence(0))
        components.append(query.get_sequence(1).reverse_complement())
    batch = read_batch.from_sequences(components)
    table = generate(batch, engine.database, max_candidates_per_read=8)
    order = np.argsort(table.read_id, kind="stable")
    bounds = np.searchsorted(table.read_id[order], np.arange(2 * len(queries) + 1))
    return engine._paired_combos(queries, batch, table, order, bounds), components, batch, table


def named_combos(engine, combos, table):
    """Each combo as (pair, strand, reference name, offsets, inner distance)."""
    return [
        (
            int(combos["pair"][k]),
            bool(table.reversed_[int(combos["row0"][k])]),
            engine.seq_db.get_sequence(int(table.ref_seq_index[int(combos["row0"][k])])).name,
            int(table.offset[int(combos["row0"][k])]),
            int(table.offset[int(combos["row1"][k])]),
            int(combos["inner"][k]),
        )
        for k in range(combos["pair"].shape[0])
    ]


@pytest.fixture(scope="module")
def paired_setup():
    ref_text = random_text(30000, 7)
    contigs = {"chrA": ref_text[:18000], "chrB": ref_text[18000:]}
    return ref_text, Api.new_database(contigs), contigs


def test_paired_combos_match_pathscounter(paired_setup):
    ref_text, index, contigs = paired_setup
    params = AlignmentParameters.defaults()
    engine = BatchAligner(index, params, CPU)
    queries = simulate_pairs(ref_text[:18000], 60, seed=11)
    combos, components, batch, table = paired_combos(engine, queries, ReadBatch, generate_candidates)

    got = []
    for k in range(combos["pair"].shape[0]):
        r0, r1 = int(combos["row0"][k]), int(combos["row1"][k])
        m0_rev = bool(table.reversed_[r0])
        ref = engine.seq_db.get_sequence(int(table.ref_seq_index[r0]))
        got.append(
            (
                int(combos["pair"][k]),
                m0_rev,
                id(ref),
                int(table.offset[r0]),
                int(table.offset[r1]),
                int(combos["inner"][k]),
            )
        )
    expected = combos_via_pathscounter(engine, queries, components, batch, table)
    assert got == expected
    assert len(got) > 50  # the scenario actually produces pairings
    other = jax_engine(contigs)
    jax_combos, _, _, jax_table = paired_combos(
        other, jax_queries(queries), JaxReadBatch, jax_generate_candidates
    )
    assert named_combos(engine, combos, table) == named_combos(other, jax_combos, jax_table)


def test_paired_vectorized_agrees_with_exact(paired_setup):
    ref_text, index, contigs = paired_setup
    params = AlignmentParameters.defaults()
    queries = simulate_pairs(ref_text[:18000], 90, seed=23)

    fast = BatchAligner(index, params, CPU, paired_vectorized=True)
    slow = BatchAligner(index, params, CPU, paired_vectorized=False)
    res_fast = fast.process_batch(queries, notify=False)
    res_slow = slow.process_batch(queries, notify=False)

    def summarize(qa):
        if qa is None:
            return None
        rows = []
        for alist in qa.get_alignments():
            rows.append(
                tuple(
                    (
                        a.get_penalty(),  # bit-exact: emission must reproduce
                        a.spacing_penalty,  # block_penalty's float64 sums
                        tuple(c.get_penalty() for c in a.get_components()),
                        tuple(c.content_key() for c in a.get_components()),
                    )
                    for a in alist
                )
            )
        return tuple(rows)

    num_aligned = 0
    for i, (a, b) in enumerate(zip(res_fast, res_slow)):
        assert summarize(a) == summarize(b), f"pair {i} diverged"
        if a is not None and a.get_first_alignments():
            num_aligned += 1
    assert num_aligned > 70  # most simulated pairs align
    assert_same_as_jax(contigs, queries, res_fast)


def test_paired_vectorized_ambiguous_reference():
    """Reference ambiguity codes give fractional per-base penalties — the
    batched emission's summation must match block_penalty bit-for-bit."""
    ref = list(random_text(6000, 3))
    rng = np.random.default_rng(4)
    for _ in range(120):  # sprinkle IUPAC codes
        ref[int(rng.integers(0, len(ref)))] = str(rng.choice(list("RYSWKMN")))
    ref_text = "".join(ref)
    index = Api.new_database({"amb": ref_text})
    params = AlignmentParameters.defaults()
    from mapper_tpu_torch.sequence import Sequence

    queries = []
    for i in range(40):
        pos = int(rng.integers(0, 6000 - 260))
        frag = ref_text[pos : pos + 250]
        # reads themselves must be unambiguous for the batch path: resolve
        frag = "".join(c if c in "ACGT" else "ACGT"[int(rng.integers(0, 4))] for c in frag)
        m1, m2 = frag[:100], rc_text(frag[-100:])
        queries.append(
            Query(
                Sequence.from_text(f"a{i}/1", m1),
                Sequence.from_text(f"a{i}/2", m2),
                expected_inner_distance=50,
                spacing_deviation_per_unit_penalty=50,
            )
        )
    fast = BatchAligner(index, params, CPU, paired_vectorized=True)
    slow = BatchAligner(index, params, CPU, paired_vectorized=False)
    rf = fast.process_batch(queries, notify=False)
    rs = slow.process_batch(queries, notify=False)
    n_aligned = 0
    for i, (a, b) in enumerate(zip(rf, rs)):
        pa = None if a is None else [[x.get_penalty() for x in al] for al in a.get_alignments()]
        pb = None if b is None else [[x.get_penalty() for x in al] for al in b.get_alignments()]
        assert pa == pb, f"pair {i}: {pa} != {pb}"
        if pa and pa[0]:
            n_aligned += 1
    assert n_aligned > 25
    assert_same_as_jax({"amb": ref_text}, queries, rf)


def test_paired_vectorized_multi_contig_and_rescue(paired_setup):
    """Pairs straddling contigs or with one unalignable mate must give the
    same answers (incl. the sequential mate-rescue fallback) in both modes."""
    ref_text, index, contigs = paired_setup
    params = AlignmentParameters.defaults()
    from mapper_tpu_torch.sequence import Sequence

    rng = np.random.default_rng(5)
    queries = []
    for i in range(12):
        pos = int(rng.integers(0, 12000 - 260))
        frag = ref_text[pos : pos + 260]
        m1 = frag[:100]
        if i % 3 == 0:
            m2 = random_text(100, seed=1000 + i)  # unalignable mate
        else:
            m2 = rc_text(frag[-100:])
        queries.append(
            Query(
                Sequence.from_text(f"x{i}/1", m1),
                Sequence.from_text(f"x{i}/2", m2),
                expected_inner_distance=60,
                spacing_deviation_per_unit_penalty=30,
            )
        )
    fast = BatchAligner(index, params, CPU, paired_vectorized=True)
    slow = BatchAligner(index, params, CPU, paired_vectorized=False)
    res_fast = fast.process_batch(queries, notify=False)
    res_slow = slow.process_batch(queries, notify=False)
    for i, (a, b) in enumerate(zip(res_fast, res_slow)):
        ka = None if a is None else [len(x) for x in a.get_alignments()]
        kb = None if b is None else [len(x) for x in b.get_alignments()]
        assert ka == kb, f"query {i}: {ka} != {kb}"
    assert_same_as_jax(contigs, queries, res_fast)
