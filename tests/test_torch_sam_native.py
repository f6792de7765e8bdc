"""The port's SAM rows, written by one native pass a batch
(`SamWriter._format`, `native/samrows.cpp`), against the JAX package's
`SamWriter`, which writes them row by row in Python: the same bytes on the
same batch, whole, one result a call, and one text a result as
`multihost.ShardedResultWriter` keeps them.  Each case draws its batch
from a seed: the engine's lazy rows (forward and reverse, one choice and
several, a read given as a reverse complement), gapped single-end rows
(soft clips, insertions, deletions, adjacent M blocks), proper pairs with
`cs:f` on both strands, half-mapped mates, a split long read's pieces
against an inferred ancestor, reads with N and IUPAC letters, penalties
across float32, and all of them in one batch.  A table the pass refuses,
and a library that cannot be built, raise."""

import io

import numpy as np
import pytest

import mapper_tpu.io.sam
from mapper_tpu_torch.align.blocks import (
    AlignedBlock,
    LazyUngappedAlignments,
    QueryAlignment,
    QueryAlignments,
    SequenceAlignment,
)
from mapper_tpu_torch.io import sam
from mapper_tpu_torch.native import samrows as native_samrows
from mapper_tpu_torch.parallel import multihost
from mapper_tpu_torch.sequence import Sequence, SequenceDatabase

KINDS = ("lazy", "lazy_choices", "lazy_rc_read", "gapped", "pairs", "half_mapped", "split", "iupac", "penalties",
         "mixed")
SEEDS = (0, 1, 2**31 + 11)
IUPAC = "ACGTMRWSYKVHDBN"


def _text(rng, length, letters="ACGT"):
    return "".join(rng.choice(list(letters), size=length))


def _penalty(rng, wide=False):
    """A penalty as the engine makes one, or (`wide`) any float32: seeded
    bit patterns, signed zeros, subnormals, the largest, infinities, NaN."""
    if not wide:
        return float(rng.integers(0, 40)) * float(rng.choice([1.0, 0.5, 1.0 / 3.0]))
    draw = rng.integers(0, 6)
    if draw == 0:
        return float(np.frombuffer(rng.integers(0, 2**32, dtype=np.uint32).tobytes(), dtype=np.float32)[0])
    if draw == 1:
        return float(rng.choice([0.0, -0.0, 1e-45, -1e-45, 1.17549435e-38, 3.4028235e38, np.inf, -np.inf, np.nan]))
    if draw == 2:
        return float(rng.uniform(-1e6, 1e6))
    if draw == 3:
        return float(rng.uniform(0, 1)) * 10.0 ** int(rng.integers(-30, 30))
    if draw == 4:
        return float(np.float32(rng.uniform(0, 200)))
    return float(rng.integers(-5, 5)) / 8.0


class _Batch:
    """A reference of two contigs and their reverse complements, reads drawn
    from a seed, and a batch of results over them."""

    def __init__(self, seed, letters="ACGT"):
        self.rng = np.random.default_rng(seed)
        self.letters = letters
        self.contigs = [Sequence.from_text(f"chr{k}", _text(self.rng, 5000)) for k in range(2)]
        self.database = SequenceDatabase(self.contigs, add_reverse_complements=True)
        self.reads = 0

    def read(self, length=None, name=None):
        length = int(self.rng.integers(40, 200)) if length is None else length
        self.reads += 1
        return Sequence.from_text(name or f"r{self.reads}", _text(self.rng, length, self.letters))

    def ref(self):
        contig = self.contigs[int(self.rng.integers(0, 2))]
        return contig.reverse_complement() if self.rng.random() < 0.5 else contig

    def lazy(self, choices=1, rc_read=False, wide=False):
        seq = self.read()
        if rc_read:
            seq = seq.reverse_complement()
        rows = [(bool(self.rng.random() < 0.5), self.ref(), int(self.rng.integers(0, 4800)),
                 _penalty(self.rng, wide)) for _ in range(choices)]
        return LazyUngappedAlignments([seq], rows, None)

    def blocks(self, length):
        """(start_a, start_b offset, length_a, length_b) of an alignment of
        a query of `length`: a soft-clipped head or tail, M blocks split in
        two, insertions and deletions, sometimes at either end."""
        rng = self.rng
        start = int(rng.integers(1, 6)) if rng.random() < 0.4 else 0
        end = length - (int(rng.integers(1, 6)) if rng.random() < 0.4 else 0)
        out, a, b = [], start, 0
        while a < end:
            draw = rng.random()
            if draw < 0.15:
                k = min(int(rng.integers(1, 4)), end - a)
                out.append((a, b, k, 0))
                a += k
            elif draw < 0.3:
                k = int(rng.integers(1, 4))
                out.append((a, b, 0, k))
                b += k
            else:
                k = min(int(rng.integers(1, 60)), end - a)
                out.append((a, b, k, k))  # adjacent M blocks stay apart
                a, b = a + k, b + k
        return out

    def component(self, seq, wide=False, history=False):
        reversed_ = bool(self.rng.random() < 0.5)
        seq_a = seq.reverse_complement() if reversed_ else seq
        ref = self.ref()
        offset = int(self.rng.integers(0, 4700))
        sections = [AlignedBlock(seq_a, ref, sa, offset + sb, la, lb) for sa, sb, la, lb in self.blocks(len(seq))]
        alignment = SequenceAlignment(sections, reversed_, _penalty(self.rng, wide), 0.0)
        if history:  # the ancestor's coordinates, written against the original's name
            original = Sequence(ref.name.replace("chr", "orig"), ref.codes)
            alignment = alignment.with_sequence_b(original)
        return alignment

    def gapped(self, wide=False):
        seq = self.read()
        choices = [QueryAlignment(self.component(seq, wide)) for _ in range(int(self.rng.integers(1, 4)))]
        return QueryAlignments.single_component([seq], choices)

    def pair(self, wide=False):
        mates = [self.read(name=f"p{self.reads}/1"), self.read(name=f"p{self.reads}/2")]
        choices = [
            QueryAlignment([self.component(mates[0], wide), self.component(mates[1], wide)],
                           spacing_penalty=_penalty(self.rng, wide))
            for _ in range(int(self.rng.integers(1, 3)))
        ]
        return QueryAlignments(mates, [choices])

    def half_mapped(self, wide=False):
        mates = [self.read(), self.read()]
        per_component = [
            [QueryAlignment(self.component(mates[i], wide), spacing_penalty=_penalty(self.rng, wide))
             for _ in range(int(self.rng.integers(0, 3)))]
            for i in range(2)
        ]
        return QueryAlignments(mates, per_component)

    def split(self):
        """A 10 kb read cut as `--split-queries-past-size 1500` cuts it,
        each piece placed against the inferred ancestor."""
        whole = self.read(length=10_000)
        pieces, prev = [], 0
        for i in range(1, 8):
            end = 10_000 * i // 7
            pieces.append(whole.get_subsequence(prev, end - prev, name=f"{whole.name}_{prev}"))
            prev = end
        return [QueryAlignments.single_choice(QueryAlignment(self.component(piece, history=True)))
                for piece in pieces]

    def results(self, kind):
        if kind == "split":
            return self.split() + self.split()
        make = {
            "lazy": lambda: self.lazy(),
            "lazy_choices": lambda: self.lazy(choices=int(self.rng.integers(2, 5))),
            "lazy_rc_read": lambda: self.lazy(choices=int(self.rng.integers(1, 4)), rc_read=True),
            "gapped": lambda: self.gapped(),
            "pairs": lambda: self.pair(),
            "half_mapped": lambda: self.half_mapped(),
            "iupac": lambda: [self.lazy, self.gapped, self.pair][int(self.rng.integers(0, 3))](),
            "penalties": lambda: [lambda: self.lazy(choices=3, wide=True), lambda: self.gapped(wide=True),
                                  lambda: self.pair(wide=True),
                                  lambda: self.half_mapped(wide=True)][int(self.rng.integers(0, 4))](),
        }
        if kind == "mixed":
            out = []
            for _ in range(40):
                draw = KINDS[int(self.rng.integers(0, len(KINDS) - 1))]
                out += self.results(draw) if draw == "split" else [make[draw]()]
            out.append(QueryAlignments.unaligned([self.read()]))
            return out
        return [make[kind]() for _ in range(60)]


def _batch(kind, seed):
    batch = _Batch(seed, IUPAC if kind in ("iupac", "mixed") else "ACGT")
    return batch.database, batch.results(kind)


def _write(database, results, paired, split=False):
    """The SAM text the port's writer makes of `results`, one batch (or,
    `split`, one result a call)."""
    stream = io.StringIO()
    writer = sam.SamWriter(database, stream, paired)
    for part in ([[r] for r in results] if split else [results]):
        writer.add_alignments(part)
    return stream.getvalue()


def _reference(database, results, paired):
    """The JAX package's writer, row by row in Python, on the same objects."""
    stream = io.StringIO()
    mapper_tpu.io.sam.SamWriter(database, stream, paired).add_alignments(results)
    return stream.getvalue()


def _rows(text):
    return [line for line in text.splitlines() if not line.startswith("@")]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_native_rows_are_the_python_rows(kind, seed):
    database, results = _batch(kind, seed)
    paired = kind in ("pairs", "half_mapped")
    text = _write(database, results, paired)
    want = _reference(database, results, paired)
    assert len(_rows(want)) > 0
    assert text == want


@pytest.mark.parametrize("kind", KINDS)
def test_texts_by_result_are_each_results_rows(kind):
    """One pass over the batch gives each result the rows the Python writer
    writes of it alone; a result with no row gets an empty text."""
    database, results = _batch(kind, 7)
    results = results + [QueryAlignments.unaligned([Sequence.from_text("none", "ACGT")])]
    writer = sam.SamWriter(database, io.StringIO(), False)
    header = writer.stream.getvalue()
    texts = writer.texts_by_result(results)
    assert len(texts) == len(results) and texts[-1] == ""
    for result, text in zip(results, texts):
        assert header + text == _reference(database, [result], False)
    assert writer.stream.getvalue() == header


def test_one_result_a_call_writes_the_batch_bytes():
    """A result with no row makes no call and writes nothing."""
    database, results = _batch("mixed", 3)
    assert _write(database, results, True, split=True) == _write(database, results, True)


def test_the_shard_writer_formats_a_batch_in_one_call(monkeypatch, tmp_path):
    """`ShardedResultWriter` over the SAM writer makes one native call a
    batch, and its shard merges back into the whole SAM."""
    database, results = _batch("mixed", 8)
    calls = []
    original = native_samrows.RowFormatter.format_rows
    monkeypatch.setattr(native_samrows.RowFormatter, "format_rows",
                        lambda self, *args: calls.append(1) or original(self, *args))
    for number, result in enumerate(results):
        result.query_sequences[0].identifier = number + 1
    shard = multihost.ShardedResultWriter(lambda stream: sam.SamWriter(database, stream, True))
    shard.add_alignments(results[:30])
    shard.add_alignments(results[30:])
    assert len(calls) == 2
    shard.save_shard(str(tmp_path / "shard.pkl"))
    merged = io.StringIO()
    multihost.merge_sam_shards([str(tmp_path / "shard.pkl")], merged)
    assert merged.getvalue() == _reference(database, results, True)


def test_a_code_the_tables_do_not_cover_is_refused(monkeypatch):
    """The native pass refuses a code past 15, and the batch raises with
    none of its rows written."""
    database, results = _batch("lazy", 5)
    bad = Sequence("bad", np.array([1, 2, 16, 4], dtype=np.uint8))
    results.append(LazyUngappedAlignments([bad], [(False, database.get_sequence(0), 0, 0.0)], None))
    stream = io.StringIO()
    writer = sam.SamWriter(database, stream, False)
    header = stream.getvalue()
    with pytest.raises(ValueError):
        writer.add_alignments(results)
    assert stream.getvalue() == header


def test_a_library_that_cannot_be_built_raises(monkeypatch):
    database, results = _batch("lazy", 9)
    monkeypatch.setattr(native_samrows, "get_library", lambda: None)
    writer = sam.SamWriter(database, io.StringIO(), False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        writer.add_alignments(results)


def test_negative_numbers_are_written_as_python_writes_them():
    """A position before a contig's start, and blocks that start before the
    query or run past its end, give negative POS, PNEXT and soft clips."""
    database, _ = _batch("lazy", 6)
    read = Sequence.from_text("neg", "ACGTACGTAC")
    mate = Sequence.from_text("neg2", "TTGCA")
    ref = database.get_sequence(0)
    ahead = SequenceAlignment([AlignedBlock(read, ref, -2, -7, 5, 5), AlignedBlock(read, ref, 3, -2, 9, 9)],
                              False, -1.5, 0.0)
    past = SequenceAlignment([AlignedBlock(mate, ref, 0, -30, 7, 7)], True, 2.0, 0.0)
    results = [
        QueryAlignments.single_component([read, mate], [QueryAlignment([ahead, past], spacing_penalty=-0.0)]),
        LazyUngappedAlignments([read], [(True, ref, -3, 0.0)], None),
    ]
    text = _write(database, results, True)
    assert text == _reference(database, results, True)
    for field in ("\t-6\t255\t-2S5M9M-2S\tchr0\t-29\t", "\t7M-2S\tchr0\t-6\t", "\t-2\t255\t10M\t*\t0\t"):
        assert field in text
    assert len(_rows(text)) == 3


def test_names_outside_ascii_pass_through():
    """Query and contig names of several bytes a character, and a lone
    surrogate as a name decoded with `surrogateescape` holds, whole and cut
    at each result."""
    contig = Sequence.from_text("chrÅ→", "ACGT" * 500)
    database = SequenceDatabase([contig], add_reverse_complements=True)
    results = [LazyUngappedAlignments([Sequence.from_text(name, "ACGTTGCAAC")], [(rev, ref, 5, 1.5)], None)
               for name, rev, ref in (("read_é", False, contig), ("读\udcff", True, contig.reverse_complement()))]
    text = _write(database, results, False)
    assert text == _reference(database, results, False)
    assert "read_é\t0\tchrÅ→\t6" in text and "读\udcff\t16\tchrÅ→-rev\t6" in text
    texts = sam.SamWriter(database, io.StringIO(), False).texts_by_result(results)
    assert "".join(texts) == _rows(text)[0] + "\n" + _rows(text)[1] + "\n"


def test_a_small_buffer_grows_to_the_batch():
    database, results = _batch("split", 4)
    want = _write(database, results, False)
    writer = sam.SamWriter(database, io.StringIO(), False)
    writer._formatter._out = np.empty(8, dtype=np.uint8)
    writer.add_alignments(results)
    assert writer.stream.getvalue() == want
    assert writer._formatter._out.shape[0] >= len(want)
