"""The port's duplication scan (`DuplicationDetector._process_length`, one
native pass a block length in `native/dupscan.cpp`) against its vectorized
numpy pass, which is the fallback where the library cannot be built, and
against the JAX package's detector on the same reference: the `pending`
list each block length hands to `_insert`, equal and in the same order;
then the same `_by_sequence` starts with each duplication's length and
positions, and the same `get_all()`.  Each reference is seeded, two contigs
with a block planted three times (two exact copies, one at 2% SNPs); one
carries IUPAC codes inside the copies, as an inferred ancestor does.  Each
at two and three interesting copies, at windows 1 and 1000; and a hand-made
packed map whose bins hold exactly `max_interesting_count` positions, one
more, and one fewer than the copies asked for."""

import numpy as np
import pytest

import mapper_tpu
import mapper_tpu.index.database
import mapper_tpu.index.duplication
import mapper_tpu_torch
import mapper_tpu_torch.index.database
import mapper_tpu_torch.index.duplication
from benchmarks.simlib import mutate, random_reference
from mapper_tpu_torch import trace
from mapper_tpu_torch.index.packedmap import PackedIndex
from mapper_tpu_torch.native import dupscan as native_dupscan

PACKAGES = {
    "jax": (mapper_tpu, mapper_tpu.index.database, mapper_tpu.index.duplication),
    "port": (mapper_tpu_torch, mapper_tpu_torch.index.database, mapper_tpu_torch.index.duplication),
}
BLOCK = (2000, 2600)  # the planted block: its span in the random text
IUPAC = "RYSWKMN"
# name -> (seed, IUPAC codes inside the copies)
REFERENCES = {"planted_17": (17, False), "planted_29": (29, False), "iupac_41": (41, True)}


def _contigs(seed: int, iupac: bool) -> dict:
    """Two contigs of a seeded random text with its block at BLOCK planted
    three more times: twice exactly, once at 2% SNPs; with `iupac`, a
    code of IUPAC in each planted copy, at the same offsets in the two
    exact ones."""
    rng = np.random.default_rng(seed)
    text = random_reference(rng, 30_000)
    block = text[BLOCK[0]:BLOCK[1]]
    copies = [block, block, "".join(mutate(rng, np.array(list(block)), 0.02))]
    if iupac:
        offsets = sorted(rng.choice(len(block), size=6, replace=False).tolist())
        for k, copy in enumerate(copies):
            chars = list(copy)
            for i, offset in enumerate(offsets[: 3 if k < 2 else 6]):
                chars[offset] = IUPAC[i % len(IUPAC)]
            copies[k] = "".join(chars)
    text = text[:9000] + copies[0] + text[9000:17000] + copies[1] + text[17000:] + copies[2]
    return {"chrA": text[:16_000], "chrB": text[16_000:]}


@pytest.fixture(scope="module")
def databases():
    """Name -> package -> the reference's hash block database."""
    found = {}
    for name, (seed, iupac) in REFERENCES.items():
        contigs = _contigs(seed, iupac)
        found[name] = {key: api.Api.new_database(contigs).hashblock_database
                       for key, (api, _, _) in PACKAGES.items()}
    return found


def _detector(package: str, database, copies: int, window: int, **kwargs):
    _, db_module, dup_module = PACKAGES[package]
    seq_db = database.get_sequence_database()
    return dup_module.DuplicationDetector(
        database, db_module.choose_min_duplication_length(seq_db), db_module.choose_max_duplication_length(seq_db),
        min_num_interesting_copies=copies, window_size=window, **kwargs,
    )


def _lengths(database) -> tuple[int, int]:
    """The port's scan's block lengths, as a range's ends."""
    seq_db = database.get_sequence_database()
    db_module = mapper_tpu_torch.index.database
    return db_module.choose_min_duplication_length(seq_db), db_module.choose_max_duplication_length(seq_db) + 1


def _recorded(detector) -> dict:
    """Block length -> the (position, length, positions) of each entry of
    the `pending` lists it handed to `_insert`, in order, as the detector
    scans."""
    pending: dict[int, list] = {}
    current: list[int] = []
    process, insert = detector._process_length, detector._insert

    def process_length(block_length, concat):
        current.append(block_length)
        process(block_length, concat)

    def record(items):
        pending.setdefault(current[-1], []).extend((pos, dup.length, list(dup.positions)) for pos, dup in items)
        insert(items)

    detector._process_length, detector._insert = process_length, record
    return pending


def _scan(detector) -> dict:
    pending = _recorded(detector)
    detector.ensure_detected()
    return {length: items for length, items in pending.items() if items}


def _by_sequence(detector) -> dict:
    return {seq: [(start, dup.length, dup.positions) for start, dup in entries]
            for seq, entries in detector._by_sequence.items()}


def _without_library(monkeypatch):
    monkeypatch.setattr(native_dupscan, "get_library", lambda: None)


@pytest.mark.parametrize("window", [1, 1000])
@pytest.mark.parametrize("copies", [2, 3])
@pytest.mark.parametrize("reference", REFERENCES)
def test_native_scan_equals_the_vectorized_pass_and_the_jax_package(databases, monkeypatch, reference, copies,
                                                                    window):
    recorder = trace.Recorder()
    native = _detector("port", databases[reference]["port"], copies, window, tracer=recorder)
    native_pending = _scan(native)
    counts = recorder._counts
    assert counts["dupscan.native_rows"] == counts["dupscan.rows"] > 0
    assert native_pending, "the planted copies make duplications"

    jax = _detector("jax", databases[reference]["jax"], copies, window)
    assert native_pending == _scan(jax)
    with monkeypatch.context() as mp:
        _without_library(mp)
        fallback = _detector("port", databases[reference]["port"], copies, window)
        assert native_pending == _scan(fallback)

    assert _by_sequence(native) == _by_sequence(fallback) == _by_sequence(jax)
    assert native._starts_by_sequence == jax._starts_by_sequence
    assert [(d.length, d.positions) for d in native.get_all()] == [(d.length, d.positions) for d in jax.get_all()]


def test_the_iupac_reference_puts_ambiguous_codes_in_scanned_windows(databases):
    """The ancestor-like reference's IUPAC codes reach the scan: some row of
    an interesting bin has one in its prefix or suffix window, so the
    passes above drop rows alike."""
    database = databases["iupac_41"]["port"]
    seq_db = database.get_sequence_database()
    ambiguous = mapper_tpu_torch.basepairs.TWO_BIT_TABLE[seq_db.concatenated_codes()] < 0
    assert ambiguous.sum() == 2 * 12  # the codes planted, on both strands
    dropped = 0
    for block_length in range(*_lengths(database)):
        m = database._map_for(block_length)
        interesting = np.nonzero((m.counts >= 2) & (m.counts <= m.max_interesting_count))[0]
        forward = np.concatenate([m.values[m.offsets[b]:m.offsets[b + 1]] for b in interesting])
        rows = np.concatenate([forward, database.reverse_complement_positions(forward, block_length)])
        width = (block_length + 3) // 4
        windows = np.r_[np.arange(width), block_length - width + np.arange(width)]
        dropped += int(ambiguous[rows[:, None] + windows[None, :]].any(axis=1).sum())
    assert dropped > 0


def _encoded(seq_db, contig: str, offset: int) -> int:
    (sequence,) = [s for s in seq_db.get_all() if s.name == contig]
    return seq_db.encode_position(sequence, offset)


def _custom_map(database, block_length: int, copies: int, maximum: int) -> PackedIndex:
    """A packed map of `block_length` over the planted reference's own
    positions: bin 0 holds exactly `maximum` positions (two offsets into
    the block, each in the block and its two exact copies; one into the
    mutated copy; filler), bin 1 one more, bin 2 one fewer than `copies`."""
    seq_db = database.get_sequence_database()
    # `_contigs`' layout: the block at 2000 and 9000 of chrA, at 1600 and
    # (mutated) 15200 of chrB
    origins = [("chrA", BLOCK[0]), ("chrA", 9000), ("chrB", 1600)]
    same_text = [_encoded(seq_db, c, o + offset) for offset in (40, 300) for c, o in origins]
    same_text.append(_encoded(seq_db, "chrB", 15200 + 300))
    filler = [_encoded(seq_db, "chrA", 100 + 37 * k) for k in range(2 * maximum)]
    bins = {0: (same_text + filler)[:maximum], 1: filler[: maximum + 1], 2: filler[: copies - 1]}
    keys = [b for b, positions in bins.items() for _ in positions]
    positions = [p for bin_positions in bins.values() for p in bin_positions]
    return PackedIndex.build(block_length, np.array(keys), np.array(positions), capacity=5,
                             max_interesting_count=maximum)


@pytest.mark.parametrize("copies", [2, 3])
def test_a_bin_at_exactly_max_interesting_count(databases, monkeypatch, copies):
    """The bin at `max_interesting_count` is scanned, the bin above it and
    the bin under `copies` are not, in both passes alike."""
    database = databases["planted_17"]["port"]
    block_length = _lengths(database)[0]
    database.require_set_up_through_size(block_length)
    maximum = 9
    custom = _custom_map(database, block_length, copies, maximum)
    assert custom.counts.tolist() == [maximum, maximum + 1, copies - 1, 0, 0]
    concat = database.get_sequence_database().concatenated_codes()
    monkeypatch.setitem(database.maps, block_length, custom)

    def pending(native: bool):
        detector = _detector("port", database, copies, 1)
        recorded = _recorded(detector)
        with monkeypatch.context() as mp:
            if not native:
                _without_library(mp)
            detector._process_length(block_length, concat)
        return recorded.get(block_length, [])

    got = pending(True)
    assert got == pending(False)
    bin_0 = custom.values[custom.offsets[0]:custom.offsets[1]]
    scanned = set(bin_0.tolist()) | set(database.reverse_complement_positions(bin_0, block_length).tolist())
    found = {pos for pos, _, _ in got}
    assert found and found <= scanned
    assert all(length == block_length and len(positions) >= copies for _, length, positions in got)


def test_the_library_refuses_a_sequence_without_its_reverse_complement(databases, monkeypatch):
    """Where the layout gives no reverse complement, the native pass
    returns None and the vectorized pass takes over, raising as the JAX
    package's does."""
    database = databases["planted_17"]["port"]
    block_length = _lengths(database)[0]
    database.require_set_up_through_size(block_length)
    seq_db = database.get_sequence_database()
    args = (database.maps[block_length], 2, block_length, seq_db.concatenated_codes(), seq_db.starts,
            database._seq_lengths)
    assert native_dupscan.group(*args, database._rc_index) is not None
    missing = np.full_like(database._rc_index, -1)
    assert native_dupscan.group(*args, missing) is None
    monkeypatch.setattr(database, "_rc_index", missing)
    with pytest.raises(KeyError):
        _detector("port", database, 2, 1)._process_length(block_length, seq_db.concatenated_codes())
