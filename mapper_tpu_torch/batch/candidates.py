"""Batched candidate generation: whole-batch seed lookup and offset voting.

The TPU-first replacement for the per-read adaptive walk of
align/candidates.py: a batch of reads is concatenated into one array, the
pyramid and gapmers are computed for the entire batch in a handful of
vectorized passes (mapper_tpu_torch.index.hashblock with segment ids), every
interesting gapmer is looked up in the packed index with one gather, and
candidate (read, strand, offset) votes come out of one lexsort.  No
data-dependent control flow per read — hash collisions and spurious offsets
simply become extra candidate rows that the scoring stage rejects (spending
predictable device FLOPs instead of branchy host time).

Output: a candidate table (read_id, reversed, ref_global_offset, votes) with
at most `max_candidates_per_read` rows per read, vote-ranked — the input to
the banded-DP scoring kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.index import hashblock
from mapper_tpu_torch.index.database import HashBlockDatabase
from mapper_tpu_torch.sequence import Sequence


@dataclass
class ReadBatch:
    """A batch of same-orientation read sequences, concatenated."""

    codes: np.ndarray  # uint8[total]
    seg: np.ndarray  # int32[total] read id per base
    starts: np.ndarray  # int64[num_reads + 1] read boundaries
    lengths: np.ndarray  # int64[num_reads]

    @staticmethod
    def from_sequences(sequences: list[Sequence]) -> "ReadBatch":
        lengths = np.array([len(s) for s in sequences], dtype=np.int64)
        starts = np.zeros(len(sequences) + 1, dtype=np.int64)
        np.cumsum(lengths, out=starts[1:])
        codes = (
            np.concatenate([s.codes for s in sequences])
            if sequences
            else np.zeros(0, dtype=np.uint8)
        )
        seg = np.repeat(np.arange(len(sequences), dtype=np.int32), lengths)
        return ReadBatch(codes, seg, starts, lengths)

    @property
    def num_reads(self) -> int:
        return int(self.lengths.shape[0])


@dataclass
class CandidateTable:
    """Vote-ranked alignment candidates for a batch."""

    read_id: np.ndarray  # int32[k]
    reversed_: np.ndarray  # bool[k]: query aligns via its reverse complement
    ref_seq_index: np.ndarray  # int32[k]: forward contig index in the database
    offset: np.ndarray  # int64[k]: contig-local offset of query position 0
    votes: np.ndarray  # int32[k]

    def __len__(self) -> int:
        return int(self.read_id.shape[0])

    def take(self, rows: np.ndarray) -> "CandidateTable":
        """Row subset (same column order)."""
        return CandidateTable(
            self.read_id[rows],
            self.reversed_[rows],
            self.ref_seq_index[rows],
            self.offset[rows],
            self.votes[rows],
        )


def collect_batch_seeds(
    batch: ReadBatch, database: HashBlockDatabase
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All interesting gapmers of the batch: returns (seg, block_start_in_read,
    block_length, num_bp, lookup_key, primary) stacked column arrays."""
    min_size = database.get_min_interesting_size()
    max_size = database.get_hashed_length()
    row = hashblock.base_row(batch.codes, seg=batch.seg)
    prefixes = hashblock.GapmerPrefixes(batch.codes)
    seg_bounds = (batch.starts[:-1], batch.starts[1:])

    segs, starts, lengths, num_bps, keys, primaries = [], [], [], [], [], []
    while len(row) >= 2:
        row = hashblock.merge_row(row)
        if len(row) == 0:
            break
        # skip gapmer expansion for rows whose largest block still can't reach
        # the minimum interesting size (the first couple of levels are the
        # biggest rows and produce nothing)
        if (
            hashblock.max_gapmer_num_basepairs_used(int(row.length.max()))
            < min_size
        ):
            continue
        g = hashblock.expand_gapmers(row, prefixes, seg_bounds=seg_bounds)
        if len(g) == 0:
            continue
        keep = (g.num_basepairs_used >= min_size) & (g.num_basepairs_used <= max_size)
        if not np.any(keep):
            if row.min_length() > max_size:
                break
            continue
        idx = g.block_index[keep]
        seg = row.seg[idx]
        segs.append(seg)
        starts.append(g.start[keep] - batch.starts[seg])
        lengths.append(g.length[keep])
        num_bps.append(g.num_basepairs_used[keep])
        keys.append(np.where(g.primary[keep], g.fwd[keep], g.rev[keep]))
        primaries.append(g.primary[keep])
        if row.min_length() > max_size:
            break
    if not segs:
        empty = np.zeros(0, dtype=np.int64)
        return (empty.astype(np.int32), empty, empty, empty, empty, empty.astype(bool))
    return (
        np.concatenate(segs),
        np.concatenate(starts),
        np.concatenate(lengths).astype(np.int64),
        np.concatenate(num_bps).astype(np.int64),
        np.concatenate(keys).astype(np.int64),
        np.concatenate(primaries),
    )


def generate_candidates(
    batch: ReadBatch,
    database: HashBlockDatabase,
    max_candidates_per_read: int = 8,
    min_votes: int = 1,
    offset_merge_distance: int = 0,
    max_matches_per_seed: int = 12,
) -> CandidateTable:
    """Seed lookup + offset voting for a whole batch.

    Each gapmer whose index bin holds at most `max_matches_per_seed` positions
    contributes one vote per stored position to the implied (read, strand,
    contig, offset); the top-voted offsets per read become candidates (seeds
    with more matches are uninformative for voting — the same sweet-spot logic
    as the reference's adaptive walk, HashBlockPath.java:153-160).
    `offset_merge_distance` merges nearby offsets (indel tolerance) by
    bucketing before voting.
    """
    if min_votes <= 1 and offset_merge_distance <= 1:
        table = _generate_candidates_native(
            batch, database, max_candidates_per_read, max_matches_per_seed
        )
        if table is not None:
            return table
    seg, block_start, block_len, num_bp, key, primary = collect_batch_seeds(batch, database)
    if seg.shape[0] == 0:
        return CandidateTable(*[np.zeros(0, dtype=t) for t in (np.int32, bool, np.int32, np.int64, np.int32)])

    seq_db = database.get_sequence_database()

    # one-gather lookup across all block sizes via the merged index view
    merged = database.merged_index()
    cap_per_seed = merged["capacities"][num_bp]
    bins = merged["bases"][num_bp] + (key % cap_per_seed)
    counts = merged["counts"][bins]
    limit = np.minimum(merged["caps"][num_bp], max_matches_per_seed)
    usable = (counts > 0) & (counts <= limit)
    sel = np.nonzero(usable)[0]
    if sel.shape[0] == 0:
        return CandidateTable(*[np.zeros(0, dtype=t) for t in (np.int32, bool, np.int32, np.int64, np.int32)])
    bin_offsets = merged["offsets"][bins[sel]]
    bin_counts = counts[sel]
    # flatten CSR ranges: repeat each seed row by its match count
    repeat_idx = np.repeat(np.arange(sel.shape[0]), bin_counts)
    flat_value_idx = np.repeat(bin_offsets, bin_counts) + _ranges(bin_counts)
    positions = merged["values"][flat_value_idx]  # encoded global positions
    seed_rows = sel[repeat_idx]

    pos_seq_idx, pos_offsets = seq_db.decode_positions(positions)
    # lookup tables: db sequence index -> (is reverse strand, forward index, length)
    rev_flags, fwd_index, seq_lengths = _strand_tables(database)

    this_primary = primary[seed_rows]
    b_start = block_start[seed_rows]
    b_len = block_len[seed_rows]
    read_len = batch.lengths[seg[seed_rows]]

    # secondary-polarity lookups return positions on the matched strand's
    # opposite sense: fold to match_block semantics
    # (database.match_block applies the transform; here we inline it)
    folded_offsets = np.where(
        this_primary,
        pos_offsets,
        seq_lengths[database._rc_index[pos_seq_idx]] - pos_offsets - b_len,
    )
    folded_seq_idx = np.where(this_primary, pos_seq_idx, database._rc_index[pos_seq_idx])
    matched_reverse = rev_flags[folded_seq_idx]
    matched_fwd_idx = fwd_index[folded_seq_idx]

    # express every match as (read strand, forward contig, read-position-0 offset)
    # forward-contig match: offset = ref_pos - block_start
    # reverse-contig match: fold to (RC read vs forward contig):
    #   rc_offset = (rc_ref_start) - (rc_query_block_start)
    #             = (L_contig - (pos + b_len)) - (L_read - (b_start + b_len))
    contig_len = seq_lengths[matched_fwd_idx]
    fwd_offset = folded_offsets - b_start
    rc_offset = (contig_len - (folded_offsets + b_len)) - (
        read_len - (b_start + b_len)
    )
    offset = np.where(matched_reverse, rc_offset, fwd_offset)

    read = seg[seed_rows]
    reversed_ = matched_reverse
    seq_idx = matched_fwd_idx.astype(np.int32)

    if offset_merge_distance > 1:
        bucket = offset // offset_merge_distance
    else:
        bucket = offset

    # vote: pack (read, reversed, seq, bucket) into one int64 key and count
    # identical rows with a single sort pass
    max_len = int(batch.lengths.max()) if batch.num_reads else 1
    n_seqs = seq_db.get_num_sequences()
    longest_contig = int(max((len(s) for s in seq_db.get_all()), default=1))
    span = longest_contig + 2 * max_len + 2
    bias = max_len + 1
    packed = (
        ((read.astype(np.int64) * 2 + reversed_) * n_seqs + seq_idx) * span
        + (bucket + bias)
    )
    if offset_merge_distance > 1:
        # bucketed keys: the representative offset is the first-encountered
        # row of each bucket, so the side arrays must ride along the sort
        order = np.argsort(packed, kind="stable")
        packed = packed[order]
        offset = offset[order]
        boundary = np.ones(packed.shape[0], dtype=bool)
        boundary[1:] = packed[1:] != packed[:-1]
        first = np.nonzero(boundary)[0]
        g_offset = offset[first]
    else:
        # unbucketed keys decode exactly: sort the packed keys alone (no
        # argsort + side-array gathers) and recover the fields afterwards
        packed.sort()
        boundary = np.ones(packed.shape[0], dtype=bool)
        boundary[1:] = packed[1:] != packed[:-1]
        first = np.nonzero(boundary)[0]
        g_offset = None
    votes = np.diff(np.append(first, packed.shape[0])).astype(np.int32)
    g_packed = packed[first]
    if g_offset is None:
        g_offset = g_packed % span - bias
    rest = g_packed // span
    g_seq = (rest % n_seqs).astype(np.int32)
    rest //= n_seqs
    g_reversed = (rest % 2).astype(bool)
    g_read = (rest // 2).astype(np.int32)

    if min_votes > 1:
        keep = votes >= min_votes
        g_read, g_reversed, g_seq, g_offset, votes = (
            g_read[keep],
            g_reversed[keep],
            g_seq[keep],
            g_offset[keep],
            votes[keep],
        )

    # top-K per read by votes: sort by (read, -votes) and cut; also drop
    # candidates far below their read's top vote (hash-collision noise) —
    # unless the top itself is weak, in which case everything stays in play
    order = np.lexsort((-votes, g_read))
    g_read, g_reversed, g_seq, g_offset, votes = (
        g_read[order],
        g_reversed[order],
        g_seq[order],
        g_offset[order],
        votes[order],
    )
    rank = _rank_within_groups(g_read)
    n_rows = g_read.shape[0]
    idx = np.arange(n_rows, dtype=np.int64)
    boundary = np.ones(n_rows, dtype=bool)
    if n_rows:
        boundary[1:] = g_read[1:] != g_read[:-1]
    group_start = np.maximum.accumulate(np.where(boundary, idx, 0))
    top_votes = votes[group_start]
    keep = rank < max_candidates_per_read
    keep &= (top_votes < 6) | (votes * 3 >= top_votes)
    return CandidateTable(
        g_read[keep].astype(np.int32),
        g_reversed[keep],
        g_seq[keep],
        g_offset[keep],
        votes[keep],
    )


def _generate_candidates_native(
    batch: ReadBatch,
    database: HashBlockDatabase,
    max_candidates_per_read: int,
    max_matches_per_seed: int,
) -> CandidateTable | None:
    """C++ implementation of the whole pyramid->lookup->vote->top-K path
    (native/candidates.cpp), bit-identical to the numpy path below.  Returns
    None when the native library is unavailable, disabled via
    MAPPER_TPU_NATIVE=0, or the batch contains ambiguity codes."""
    import os

    if os.environ.get("MAPPER_TPU_NATIVE", "1") == "0":
        return None
    from mapper_tpu_torch import native

    seq_db = database.get_sequence_database()
    n_seqs = seq_db.get_num_sequences()
    if n_seqs == 0 or batch.num_reads == 0:
        return None
    max_len = int(batch.lengths.max())
    longest_contig = int(max((len(s) for s in seq_db.get_all()), default=1))
    span = longest_contig + 2 * max_len + 2
    bias = max_len + 1
    rev_flags, fwd_index, seq_lengths = _strand_tables(database)
    result = native.native_generate_candidates(
        batch.codes,
        batch.starts,
        database.get_min_interesting_size(),
        database.get_hashed_length(),
        database.merged_index(),
        rev_flags,
        fwd_index,
        seq_lengths,
        database._rc_index,
        seq_db.starts,
        n_seqs,
        span,
        bias,
        max_matches_per_seed,
        max_candidates_per_read,
    )
    if result is None:
        return None
    read, reversed_, seq_idx, offset, votes = result
    return CandidateTable(read, reversed_, seq_idx, offset, votes)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(total, dtype=np.int64)
    resets = np.zeros(total, dtype=np.int64)
    ends = np.cumsum(counts)[:-1]
    resets[ends] = counts[:-1]
    return idx - np.cumsum(resets)


def _rank_within_groups(sorted_group_keys: np.ndarray) -> np.ndarray:
    n = sorted_group_keys.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    boundary = np.ones(n, dtype=bool)
    boundary[1:] = sorted_group_keys[1:] != sorted_group_keys[:-1]
    idx = np.arange(n, dtype=np.int64)
    group_start = np.maximum.accumulate(np.where(boundary, idx, 0))
    return idx - group_start


def _strand_tables(database: HashBlockDatabase):
    """(is_reverse_strand, forward_index, length) arrays per db sequence.

    Cached on the database object itself (an id()-keyed dict would serve stale
    tables when object ids are recycled after garbage collection)."""
    cached = getattr(database, "_strand_tables_cache", None)
    if cached is not None:
        return cached
    seq_db = database.get_sequence_database()
    n = seq_db.get_num_sequences()
    rev_flags = np.zeros(n, dtype=bool)
    fwd_index = np.arange(n, dtype=np.int64)
    lengths = np.zeros(n, dtype=np.int64)
    for i, seq in enumerate(seq_db.get_all()):
        lengths[i] = len(seq)
        if seq.complemented_from is not None:
            rev_flags[i] = True
            fwd_index[i] = seq_db.index_of(seq.complemented_from)
    result = (rev_flags, fwd_index, lengths)
    database._strand_tables_cache = result
    return result
