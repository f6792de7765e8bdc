"""The port's pileup (`mapper_tpu_torch/pileup.py`, one native pass in
`native/pileup.cpp`) against the JAX package's `MatchDatabase` on the same
alignments: every contig's `middle`, `end` and `deletion_start_middle`
equal under `np.array_equal`, its insertion events equal and in the same
order, the contigs in the same order.  Each case draws its alignments from
a seed: weights 1, 1/2 and 1/3 (and 1 with 1/3 on the same positions), both
strands, reads at either end of a contig, indels at a read's ends, mates
that overlap and mates apart, the engine's lazy rows and materialized
objects, one contig or two; each at end fractions 0, 0.1 and 0.5."""

from types import SimpleNamespace

import numpy as np
import pytest

import mapper_tpu.align.blocks
import mapper_tpu.pileup
import mapper_tpu.sequence
import mapper_tpu_torch.align.blocks
import mapper_tpu_torch.pileup
import mapper_tpu_torch.sequence
from mapper_tpu_torch import trace
from mapper_tpu_torch.native import pileup as native_pileup

PACKAGES = {
    "jax": SimpleNamespace(blocks=mapper_tpu.align.blocks, pileup=mapper_tpu.pileup, sequence=mapper_tpu.sequence),
    "port": SimpleNamespace(
        blocks=mapper_tpu_torch.align.blocks, pileup=mapper_tpu_torch.pileup, sequence=mapper_tpu_torch.sequence
    ),
}
COMPLEMENT = str.maketrans("ACGTN", "TGCAN")


def _rc(text: str) -> str:
    return text.translate(COMPLEMENT)[::-1]


def _mutate(rng, text: str) -> str:
    chars = list(text)
    for _ in range(int(rng.integers(0, 4))):
        chars[int(rng.integers(0, len(chars)))] = "ACGTN"[int(rng.integers(0, 5))]
    return "".join(chars)


class _Scenario:
    """Alignments as plain data (texts and coordinates), made once from a
    seed and built as either package's objects."""

    def __init__(self, seed, contigs=1, choices=(1,), strands=(False, True), lazy=0.0, gapped=0.0, pairs=0.0,
                 overlap=0.5, at_ends=0.0, positions=None, count=150):
        rng = np.random.default_rng(seed)
        self.contigs = []
        for k in range(contigs):
            text = "".join(rng.choice(list("ACGT"), size=int(rng.integers(700, 1000))))
            text = text[:100] + "N" + text[101:]  # an ambiguous reference base
            self.contigs.append((f"chr{k}", text))
        self.reads = []  # (name, text)
        self.queries = []
        for _ in range(count):
            draw = rng.random()
            if draw < lazy:
                self.queries.append(self._lazy(rng, choices, strands, at_ends, positions))
            elif draw < lazy + pairs:
                self.queries.append(self._pair(rng, choices, overlap, gapped))
            else:
                self.queries.append(self._single(rng, choices, strands, gapped, at_ends, positions))

    def _read(self, text: str) -> int:
        self.reads.append((f"r{len(self.reads)}", text))
        return len(self.reads) - 1

    def _place(self, rng, strands, span, at_ends, positions):
        """(contig, folded, start on that strand's sequence)."""
        contig = int(rng.integers(0, len(self.contigs)))
        folded = bool(rng.choice(strands))
        n = len(self.contigs[contig][1])
        if rng.random() < at_ends:
            start = 0 if rng.random() < 0.5 else n - span
        elif positions is not None:
            start = int(rng.choice(positions))
        else:
            start = int(rng.integers(0, n - span))
        return contig, folded, start

    def _strand_text(self, contig, folded):
        text = self.contigs[contig][1]
        return _rc(text) if folded else text

    def _blocks(self, rng, gapped, length, indel_ends=True):
        """Blocks (start_a, start_b offset, length_a, length_b) of one
        alignment of about `length` query bases; gapped ones carry an
        insertion or a deletion, sometimes as the first or last block, and
        sometimes an unaligned head."""
        if rng.random() >= gapped:
            return [(0, 0, length, length)], length, length
        ops = []
        head = int(rng.integers(0, 3)) if rng.random() < 0.3 else 0
        if indel_ends and rng.random() < 0.3:
            ops.append(("I", int(rng.integers(1, 4))) if rng.random() < 0.5 else ("D", int(rng.integers(1, 4))))
        first = int(rng.integers(10, length - 20))
        ops.append(("M", first))
        ops.append(("I", int(rng.integers(1, 4))) if rng.random() < 0.5 else ("D", int(rng.integers(1, 4))))
        ops.append(("M", length - first - 5))
        if indel_ends and rng.random() < 0.3:
            ops.append(("I", int(rng.integers(1, 4))) if rng.random() < 0.5 else ("D", int(rng.integers(1, 4))))
        blocks, qa, rb = [], head, 0
        for op, k in ops:
            if op == "M":
                blocks.append((qa, rb, k, k))
                qa, rb = qa + k, rb + k
            elif op == "I":
                blocks.append((qa, rb, k, 0))
                qa += k
            else:
                blocks.append((qa, rb, 0, k))
                rb += k
        return blocks, qa + int(rng.integers(0, 3)), rb

    def _component(self, rng, strands, gapped, at_ends, positions, length, place=None, shape=None):
        blocks, qlen, span = shape or self._blocks(rng, gapped, length)
        contig, folded, start = place or self._place(rng, strands, span, at_ends, positions)
        start = min(start, len(self.contigs[contig][1]) - span)
        ref_text = self._strand_text(contig, folded)
        query = list("".join(rng.choice(list("ACGT"), size=qlen)))
        for sa, sb, la, lb in blocks:
            if la == lb:
                query[sa : sa + la] = ref_text[start + sb : start + sb + lb]
        text = _mutate(rng, "".join(query))
        # the read as sequenced: sometimes the reverse complement of what aligns
        as_rc = bool(rng.random() < 0.3)
        read = self._read(_rc(text) if as_rc else text)
        return {"read": read, "rc": as_rc, "contig": contig, "folded": folded, "shape": (blocks, qlen, span),
                "blocks": [(sa, start + sb, la, lb) for sa, sb, la, lb in blocks]}

    def _single(self, rng, choices, strands, gapped, at_ends, positions):
        n = int(rng.choice(choices))
        length = int(rng.integers(40, 150))
        first = self._component(rng, strands, gapped, at_ends, positions, length)
        options = [[first]]
        for _ in range(n - 1):
            # another placement of the same read: its blocks' shape, elsewhere
            other = self._component(rng, strands, gapped, at_ends, positions, length, shape=first["shape"])
            options.append([dict(other, read=first["read"], rc=first["rc"])])
        return {"kind": "objects", "reads": [first["read"]], "choices": options}

    def _pair(self, rng, choices, overlap, gapped):
        n = int(rng.choice(choices))
        length = int(rng.integers(60, 120))
        options, shapes = [], (None, None)
        for _ in range(n):
            # both mates on one strand of one contig; every choice places
            # the first choice's mates (their reads, their blocks' shapes)
            contig = int(rng.integers(0, len(self.contigs)))
            folded = bool(rng.random() < 0.5)
            start = int(rng.integers(0, len(self.contigs[contig][1]) - 3 * length))
            gap = int(rng.integers(-length + 5, 0)) if rng.random() < overlap else int(rng.integers(0, length))
            one = self._component(rng, (folded,), gapped, 0.0, None, length, place=(contig, folded, start),
                                  shape=shapes[0])
            two = self._component(rng, (folded,), gapped, 0.0, None, length,
                                  place=(contig, folded, start + length + gap), shape=shapes[1])
            if not options:
                first, shapes = (one, two), (one["shape"], two["shape"])
            options.append([dict(one, read=first[0]["read"], rc=first[0]["rc"]),
                            dict(two, read=first[1]["read"], rc=first[1]["rc"])])
        reads = [first[0]["read"], first[1]["read"]]
        return {"kind": "objects", "reads": reads, "choices": options}

    def _lazy(self, rng, choices, strands, at_ends, positions):
        n = int(rng.choice(choices))
        length = int(rng.integers(40, 150))
        rows = []
        for _ in range(n):
            contig, folded, start = self._place(rng, strands, length, at_ends, positions)
            rows.append((bool(rng.random() < 0.5), contig, folded, start))
        rev, contig, folded, start = rows[0]
        text = _mutate(rng, self._strand_text(contig, folded)[start : start + length])
        read = self._read(_rc(text) if rev else text)
        return {"kind": "lazy", "reads": [read], "rows": rows}

    def build(self, package):
        """The scenario as `package`'s QueryAlignments."""
        Sequence = package.sequence.Sequence
        blocks = package.blocks
        encode = package.sequence.basepairs.encode
        contigs = [Sequence.from_text(name, text) for name, text in self.contigs]
        strand = [(c, c.reverse_complement()) for c in contigs]
        reads = [Sequence(name, encode(text), identifier=i) for i, (name, text) in enumerate(self.reads)]
        results = []
        for q in self.queries:
            sequences = [reads[r] for r in q["reads"]]
            if q["kind"] == "lazy":
                rows = [(rev, strand[c][folded], start, 0.0) for rev, c, folded, start in q["rows"]]
                results.append(blocks.LazyUngappedAlignments(sequences, rows, None))
                continue
            choices = []
            for option in q["choices"]:
                components = []
                for comp in option:
                    seq_a = reads[comp["read"]]
                    seq_a = seq_a.reverse_complement() if comp["rc"] else seq_a
                    ref = strand[comp["contig"]][comp["folded"]]
                    sections = [blocks.AlignedBlock(seq_a, ref, *b) for b in comp["blocks"]]
                    components.append(blocks.SequenceAlignment(sections, comp["folded"], 0.0, 0.0))
                choices.append(blocks.QueryAlignment(components))
            results.append(blocks.QueryAlignments(sequences, [choices]))
        return results


CASES = {
    "weight_1": dict(choices=(1,), strands=(False,)),
    "weight_half": dict(choices=(2,)),
    "weight_third": dict(choices=(3,)),
    "weights_1_and_third_same_positions": dict(choices=(1, 3), positions=(50, 200, 333)),
    "reverse_strand_only": dict(choices=(1, 2), strands=(True,)),
    "contig_ends": dict(choices=(1, 2, 3), at_ends=0.6),
    "indels_at_read_ends": dict(choices=(1, 2, 3), gapped=1.0),
    "mates_overlapping": dict(choices=(1, 2, 3), pairs=1.0, overlap=1.0, gapped=0.4),
    "mates_apart": dict(choices=(1, 2), pairs=1.0, overlap=0.0, gapped=0.4),
    "lazy_rows": dict(choices=(1, 2, 3), lazy=1.0, at_ends=0.2),
    "lazy_and_objects_two_contigs": dict(contigs=2, choices=(1, 2, 3), lazy=0.5, pairs=0.2, gapped=0.3,
                                         at_ends=0.1, positions=(10, 400)),
}


def _pileups(package, scenario, query_end_fraction, **kwargs):
    database = package.pileup.MatchDatabase(query_end_fraction)
    database.add_alignments(scenario.build(package))
    return database, database.group_by_position(**kwargs)


def _assert_same(got: dict, want: dict):
    assert [s.name for s in got] == [s.name for s in want]
    for (seq, g), w in zip(got.items(), want.values()):
        for name in ("middle", "end", "deletion_start_middle"):
            assert np.array_equal(getattr(g, name), getattr(w, name)), (seq.name, name)
        assert list(g.insertions.items()) == list(w.insertions.items()), seq.name


@pytest.mark.parametrize("query_end_fraction", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("case", list(CASES))
def test_port_pileup_equals_the_jax_package(case, query_end_fraction):
    scenario = _Scenario(sum(map(ord, case)), **CASES[case])
    tracer = trace.Recorder()
    _, got = _pileups(PACKAGES["port"], scenario, query_end_fraction, tracer=tracer)
    _, want = _pileups(PACKAGES["jax"], scenario, query_end_fraction)
    assert got and want
    _assert_same(got, want)
    # every alignment took the native pass
    counts = tracer._counts
    assert counts["pileup.native"] == counts["pileup.alignments"] > 0


def test_native_pass_equals_the_python_fallback(monkeypatch):
    scenario = _Scenario(7, **CASES["lazy_and_objects_two_contigs"])
    _, native = _pileups(PACKAGES["port"], scenario, 0.1)
    monkeypatch.setattr(native_pileup, "get_library", lambda: None)
    tracer = trace.Recorder()
    _, fallback = _pileups(PACKAGES["port"], scenario, 0.1, tracer=tracer)
    _assert_same(native, fallback)
    assert tracer._counts["pileup.native"] == 0 and tracer._counts["pileup.alignments"] > 0
