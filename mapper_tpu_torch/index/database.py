"""The hashblock index over a reference: build driver + lookup view.

Equivalent of the reference's HashBlock_Database + Readable_HashBlock_Database
(HashBlock_Database.java, Readable_HashBlock_Database.java): owns one
PackedIndex per block size (numBasepairsUsed), hashes the reference's forward
sequences through a target size, and supports lazy growth when a query needs
longer blocks (requireSetUpThroughSize, java:148-215).

TPU-first: the whole reference is hashed with the vectorized pyramid (one
numpy pass per level per contig — the reference's 50kb HashJobs and
work-stealing threads exist to parallelize its per-block object walk, which
the vectorization replaces), and the per-size CSR arrays are directly
device-transferable for batched gather lookups.

The reference's sizing rules are ported exactly so bin layouts and counts
match:
  - minInterestingSize = max(log4(totalForwardSize+1) - 2, 1)   (java:52)
  - initial max size = DuplicationDetector.chooseMaxDuplicationLength
  - growth: maxInterestingSize = 2 * requested size               (java:192)
"""

from __future__ import annotations

import math
import os

import numpy as np

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.index import hashblock, scalar
from mapper_tpu_torch.index.dircache import DirCache
from mapper_tpu_torch.index.packedmap import (
    PackedIndex,
    estimate_required_capacity,
    max_interesting_count_per_key,
)
from mapper_tpu_torch.sequence import Sequence, SequenceDatabase

_INT_MAX = 2**31 - 1


def log2_round_up(x: int) -> int:
    """Bits needed to encode x distinct values (QuickVariants
    SequenceDatabase.log2RoundUp, used by DuplicationDetector.java:18)."""
    if x <= 1:
        return 1
    return (x - 1).bit_length()


def choose_min_duplication_length(seq_db: SequenceDatabase) -> int:
    """DuplicationDetector.chooseMinDuplicationLength (java:17-31)."""
    return log2_round_up(seq_db.get_total_forward_size())


def choose_max_duplication_length(seq_db: SequenceDatabase) -> int:
    return choose_min_duplication_length(seq_db) * 2


class HashBlockDatabase:
    """Per-size packed hash indexes over the reference's forward sequences."""

    def __init__(
        self,
        sequence_database: SequenceDatabase,
        min_interesting_size: int = -1,
        hint_max_interesting_size: int = -1,
        max_num_short_matches: int = -1,
        enable_gapmers: bool = True,
        cache_dir: str | DirCache | None = None,
        logger=None,
    ):
        from mapper_tpu_torch.logging import NO_OP_LOGGER

        # reference-verbosity tracing (--verbose-reference; the reference's
        # referenceLogger threads through the index build, Mapper.java:1017)
        self.logger = logger if logger is not None else NO_OP_LOGGER
        self.sequence_database = sequence_database
        self.enable_gapmers = enable_gapmers
        self.total_forward_size = sequence_database.get_total_forward_size()

        if min_interesting_size <= 0:
            # (int)max(log(total+1)/log(4) - 2, 1)   (HashBlock_Database.java:52)
            self.min_interesting_size = int(
                max(math.log(self.total_forward_size + 1) / math.log(4) - 2, 1)
            )
        else:
            self.min_interesting_size = min_interesting_size

        if max_num_short_matches < 0:
            self.max_num_short_matches = 5  # java:84
        else:
            self.max_num_short_matches = max_num_short_matches

        if hint_max_interesting_size > 0:
            initial_max = hint_max_interesting_size
        else:
            initial_max = choose_max_duplication_length(sequence_database)

        import threading

        self.maps: dict[int, PackedIndex] = {}
        self.max_fully_set_up_size = 0
        self._growth_lock = threading.Lock()

        if isinstance(cache_dir, str):
            cache_dir = DirCache(cache_dir)
        self._dir_cache = cache_dir
        self._cache_content_dir: str | None = None
        if cache_dir is not None:
            keys = dict(sequence_database.get_cache_keys())
            keys.update(
                {
                    "enableGapmers": str(self.enable_gapmers),
                    "minInterestingSize": str(self.min_interesting_size),
                    "maxNumShortMatches": str(self.max_num_short_matches),
                    "formatVersion": "2",
                    "type": "HashBlock_Database",
                }
            )
            self._cache_content_dir = cache_dir.get_or_create_dir(keys)

        # sequence metadata arrays for vectorized position transforms
        seqs = sequence_database.get_all()
        self._seq_lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        rc = np.full(len(seqs), -1, dtype=np.int64)
        for i, seq in enumerate(seqs):
            try:
                rc[i] = sequence_database.index_of(sequence_database.get_reverse_complement(seq))
            except KeyError:
                pass
        self._rc_index = rc

        self._hash_through(initial_max)

    # --- public sizing accessors ----------------------------------------

    def get_min_interesting_size(self) -> int:
        return self.min_interesting_size

    def get_hashed_length(self) -> int:
        return self.max_fully_set_up_size

    def get_sequence_database(self) -> SequenceDatabase:
        return self.sequence_database

    def get_enable_gapmers(self) -> bool:
        return self.enable_gapmers

    def get_original_sequence(self, sequence: Sequence) -> Sequence:
        return sequence  # HashBlock_Database doesn't modify sequences (java:124-127)

    def get_hashblock_database(self):
        return self  # ReferenceProvider interface (java:116-118)

    # --- build -----------------------------------------------------------

    def require_set_up_through_size(self, size: int) -> None:
        """Lazy growth (HashBlock_Database.requireSetUpThroughSize +
        chooseNextHashSize, java:148-215): hash through 2x the requested size.
        Thread-safe: pipelined batches may trigger growth concurrently."""
        if size <= self.max_fully_set_up_size:
            return
        with self._growth_lock:
            if size <= self.max_fully_set_up_size:
                return
            self._hash_through(size * 2)

    def _cache_file(self, size: int) -> str | None:
        if self._cache_content_dir is None:
            return None
        return os.path.join(self._cache_content_dir, f"length-{size}.npz")

    def _hash_through(self, max_size: int) -> None:
        """Hash all forward sequences, storing gapmers with numBasepairsUsed in
        (max_fully_set_up_size, max_size]."""
        lo = self.max_fully_set_up_size
        if max_size <= lo:
            return

        # try to load the new sizes from the cache; stop at the first miss
        # (HashBlock_Database.chooseNextHashSize/helpLoadOnce, java:196-334)
        loaded_through = lo
        all_loaded = True
        pending: dict[int, PackedIndex] = {}
        for size in range(max(self.min_interesting_size, lo + 1), max_size + 1):
            path = self._cache_file(size)
            if path is None or not os.path.exists(path):
                all_loaded = False
                break
            try:
                pending[size] = PackedIndex.load(path)
                loaded_through = size
            except Exception:
                all_loaded = False
                break
        if all_loaded:
            self.maps.update(pending)
            for size in range(lo + 1, max_size + 1):
                if size not in self.maps:
                    self.maps[size] = PackedIndex.empty(size)
            self.max_fully_set_up_size = max_size
            if self.logger.get_enabled():
                self.logger.log(
                    f"Loaded hashblock sizes {lo + 1}..{max_size} from cache"
                )
            return

        if self.logger.get_enabled():
            self.logger.log(
                f"Hashing reference blocks of sizes {max(self.min_interesting_size, lo + 1)}"
                f"..{max_size} ({self.total_forward_size}bp forward)"
            )

        by_size_keys: dict[int, list[np.ndarray]] = {}
        by_size_positions: dict[int, list[np.ndarray]] = {}
        by_size_amb: dict[int, list[np.ndarray]] = {}

        for seq in self.sequence_database.get_forward_sequences_only():
            self._hash_sequence(seq, lo, max_size, by_size_keys, by_size_positions, by_size_amb)

        for size in range(lo + 1, max_size + 1):
            if size in by_size_keys:
                keys = np.concatenate(by_size_keys[size])
                positions = np.concatenate(by_size_positions[size])
                amb = np.concatenate(by_size_amb[size])
                capacity = estimate_required_capacity(
                    size, self.total_forward_size, self.enable_gapmers
                )
                cap = max_interesting_count_per_key(size, self.max_num_short_matches)
                self.maps[size] = PackedIndex.build(
                    size, keys, positions, capacity, cap, dedup_mask=amb
                )
                if self.logger.get_enabled():
                    self.logger.log(
                        f" hashed size {size}: {keys.shape[0]} blocks"
                    )
            else:
                self.maps[size] = PackedIndex.empty(size)
            path = self._cache_file(size)
            if path is not None and size >= self.min_interesting_size:
                self.maps[size].save(path)
        self.max_fully_set_up_size = max_size

    def _hash_sequence(
        self,
        seq: Sequence,
        lo: int,
        hi: int,
        by_size_keys: dict[int, list[np.ndarray]],
        by_size_positions: dict[int, list[np.ndarray]],
        by_size_amb: dict[int, list[np.ndarray]],
    ) -> None:
        codes = seq.codes
        seq_start = self.sequence_database.encode_position(seq, 0)
        rc_seq = self.sequence_database.get_reverse_complement(seq)
        rc_start = self.sequence_database.encode_position(rc_seq, 0)
        n = len(seq)

        has_ambiguity = bool(np.any(basepairs.TWO_BIT_TABLE[codes] < 0))
        if not has_ambiguity and self.enable_gapmers:
            import os

            if os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
                from mapper_tpu_torch import native

                # fused parallel collect+emit: the C++ side walks the pyramid
                # in overlapping windows (the reference's 50 kb HashJob model,
                # HashBlock_Database.java:218-235) and returns the
                # dual-polarity inserts already grouped by size; PackedIndex
                # canonicalizes (bin, position) order, so this is
                # bit-identical to the sequential collect+_emit path
                emitted = native.native_collect_emit(
                    codes, self.min_interesting_size, lo, hi, seq_start, rc_start
                )
                if emitted is not None:
                    size_counts, keys, positions = emitted
                    bounds = np.zeros(size_counts.shape[0] + 1, dtype=np.int64)
                    np.cumsum(size_counts, out=bounds[1:])
                    for size in np.nonzero(size_counts)[0].tolist():
                        sl = slice(bounds[size], bounds[size + 1])
                        by_size_keys.setdefault(size, []).append(keys[sl])
                        by_size_positions.setdefault(size, []).append(positions[sl])
                        by_size_amb.setdefault(size, []).append(
                            np.zeros(int(size_counts[size]), dtype=bool)
                        )
                    return
        if not has_ambiguity:
            prefixes = hashblock.GapmerPrefixes(codes)
            for row in hashblock.build_pyramid(codes):
                if len(row) == 0 or row.min_length() > hi:
                    break
                if self.enable_gapmers:
                    # rows whose largest block cannot reach the minimum
                    # interesting size produce nothing (the first levels are
                    # the biggest rows)
                    if (
                        hashblock.max_gapmer_num_basepairs_used(int(row.length.max()))
                        < self.min_interesting_size
                    ):
                        continue
                    g = hashblock.expand_gapmers(row, prefixes)
                    num_bp = g.num_basepairs_used
                    fwd, rev = g.fwd, g.rev
                    primary, secondary = g.primary, g.secondary
                    start, length = g.start, g.length
                else:
                    num_bp = row.length
                    fwd, rev = row.fwd, row.rev
                    flags_differ = row.req_l != row.req_r
                    primary = np.where(flags_differ, row.req_l, fwd >= rev)
                    secondary = np.where(flags_differ, row.req_r, fwd <= rev)
                    start, length = row.start, row.length
                keep = (
                    (num_bp >= self.min_interesting_size)
                    & (num_bp > lo)
                    & (num_bp <= hi)
                )
                if not np.any(keep):
                    continue
                self._emit(
                    num_bp[keep],
                    fwd[keep],
                    rev[keep],
                    primary[keep],
                    secondary[keep],
                    start[keep],
                    length[keep],
                    np.zeros(int(keep.sum()), dtype=bool),
                    seq_start,
                    rc_start,
                    n,
                    by_size_keys,
                    by_size_positions,
                    by_size_amb,
                )
        else:
            # Sequences containing ambiguity codes (IUPAC): block formation is
            # a local function of sequence content (the reference exploits the
            # same property in HashBlock_Compiler's lookahead memoizer,
            # HashBlock_Compiler.java:74-90), so sparse ambiguity — the shape
            # ancestry inference produces — hashes as native/vectorized clean
            # segments plus scalar windows around each ambiguous position.
            if not self._hash_sequence_hybrid(
                codes, lo, hi, seq_start, rc_start, n,
                by_size_keys, by_size_positions, by_size_amb,
            ):
                # dense ambiguity: full scalar pass
                self._emit_entry_arrays(
                    self._scalar_entry_arrays(codes, lo, hi),
                    seq_start, rc_start, n,
                    by_size_keys, by_size_positions, by_size_amb,
                )

    def _scalar_entry_arrays(self, codes, lo, hi, offset=0, keep=None):
        """Column arrays (num_bp, fwd, rev, primary, secondary, start, length,
        amb) of the scalar conditional pyramid over ``codes``, starts shifted
        by ``offset`` into full-sequence coordinates; native C++ when
        available, else the Python scalar oracle."""
        import os

        if os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
            from mapper_tpu_torch import native

            res = native.native_scalar_entries(
                codes,
                self.min_interesting_size,
                lo,
                hi,
                self.enable_gapmers,
                keep=None if keep is None else (keep[0] - offset, keep[1] - offset),
            )
            if res is not None:
                num_bp, fwd, rev, primary, secondary, start, length, amb = res
                return (
                    num_bp.astype(np.int64),
                    fwd.astype(np.int64),
                    rev.astype(np.int64),
                    primary,
                    secondary,
                    start + offset,
                    length.astype(np.int64),
                    amb,
                )
        entries = self._scalar_entries(codes, lo, hi, offset=offset, keep=keep)
        arr = np.array(entries, dtype=np.int64).reshape(-1, 8)
        return (
            arr[:, 0], arr[:, 1], arr[:, 2],
            arr[:, 3].astype(bool), arr[:, 4].astype(bool),
            arr[:, 5], arr[:, 6], arr[:, 7].astype(bool),
        )

    def _emit_entry_arrays(
        self, columns, seq_start, rc_start, n,
        by_size_keys, by_size_positions, by_size_amb,
    ):
        num_bp, fwd, rev, primary, secondary, start, length, amb = columns
        if num_bp.shape[0] == 0:
            return
        self._emit(
            num_bp, fwd, rev, primary, secondary, start, length, amb,
            seq_start, rc_start, n,
            by_size_keys, by_size_positions, by_size_amb,
        )

    def _scalar_entries(self, codes, lo, hi, offset=0, keep=None):
        """Scalar-pyramid pass over ``codes`` returning emit tuples.  ``offset``
        shifts block starts into full-sequence coordinates; ``keep`` optionally
        restricts output to blocks whose (shifted) start lies in [keep[0],
        keep[1])."""
        entries = []  # (num_bp, fwd, rev, primary, secondary, start, length, amb)
        for row in scalar.scalar_pyramid(codes):
            if not row:
                break
            min_len = min(
                (b.length for b, _ in scalar.iter_concrete_blocks(row)), default=1 << 30
            )
            if min_len > hi:
                break
            for block, is_conditional in scalar.iter_concrete_blocks(row):
                g = block.with_gap_and_extension(codes) if self.enable_gapmers else block
                if g is None:
                    continue
                if not (self.min_interesting_size <= g.num_basepairs_used <= hi):
                    continue
                if g.num_basepairs_used <= lo:
                    continue
                start = g.start + offset
                if keep is not None and not (keep[0] <= start < keep[1]):
                    continue
                entries.append(
                    (
                        g.num_basepairs_used,
                        g.fwd,
                        g.rev,
                        g.is_primary_polarity(),
                        g.is_secondary_polarity(),
                        start,
                        g.length,
                        is_conditional,
                    )
                )
        return entries

    def _collect_clean(self, codes, lo, hi):
        """All insertable blocks of a clean (ambiguity-free) code stretch as
        arrays (num_bp, fwd, rev, primary, secondary, start, length), via the
        native collector when available, else the vectorized pyramid."""
        if self.enable_gapmers:
            import os

            if os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
                from mapper_tpu_torch import native

                collected = native.native_collect_blocks(
                    codes, self.min_interesting_size, lo, hi
                )
                if collected is not None:
                    return collected
        parts = []
        prefixes = hashblock.GapmerPrefixes(codes) if self.enable_gapmers else None
        for row in hashblock.build_pyramid(codes):
            if len(row) == 0 or row.min_length() > hi:
                break
            if self.enable_gapmers:
                if (
                    hashblock.max_gapmer_num_basepairs_used(int(row.length.max()))
                    < self.min_interesting_size
                ):
                    continue
                g = hashblock.expand_gapmers(row, prefixes)
                num_bp, fwd, rev = g.num_basepairs_used, g.fwd, g.rev
                primary, secondary = g.primary, g.secondary
                start, length = g.start, g.length
            else:
                num_bp = row.length
                fwd, rev = row.fwd, row.rev
                flags_differ = row.req_l != row.req_r
                primary = np.where(flags_differ, row.req_l, fwd >= rev)
                secondary = np.where(flags_differ, row.req_r, fwd <= rev)
                start, length = row.start, row.length
            keep = (
                (num_bp >= self.min_interesting_size) & (num_bp > lo) & (num_bp <= hi)
            )
            if np.any(keep):
                parts.append(
                    (num_bp[keep], fwd[keep], rev[keep], primary[keep],
                     secondary[keep], start[keep], length[keep])
                )
        if not parts:
            z = np.zeros(0, dtype=np.int64)
            return (z.astype(np.int32), z.astype(np.int32), z.astype(np.int32),
                    z.astype(bool), z.astype(bool), z, z.astype(np.int32))
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(7))

    # hybrid hashing constants: block formation converges within ~64 bp of a
    # window edge (validated empirically incl. low-entropy content); a gapmer
    # of numBasepairsUsed <= hi spans < 3*hi bp including gap+extension
    # (HashBlock.java:11-13: maxSpan = L + 9L/8 + 1).
    _HYBRID_MAX_AMB_FRACTION = 0.05

    def _hash_sequence_hybrid(
        self, codes, lo, hi, seq_start, rc_start, n,
        by_size_keys, by_size_positions, by_size_amb,
    ) -> bool:
        """Hash a sequence with *sparse* ambiguity: scalar (with conditional
        IUPAC expansion) only inside windows around ambiguous positions,
        native/vectorized everywhere else.  Partition rule: a block belongs to
        the scalar pass iff its start lies in a "territory" around a group of
        ambiguous positions; territories are far enough from both the scalar
        window's edges and the clean segments' edges that both passes agree on
        every block near the boundary.  Returns False when ambiguity is too
        dense to pay off (caller falls back to the full scalar pass)."""
        amb_pos = np.nonzero(basepairs.TWO_BIT_TABLE[codes] < 0)[0]
        if amb_pos.size == 0 or amb_pos.size > max(8, int(n * self._HYBRID_MAX_AMB_FRACTION)):
            return False
        span = 3 * hi  # upper bound on a gapmer's footprint in bp
        territory_pad = span + 64  # blocks starting further away never see the ambiguity
        window_pad = territory_pad + span + 128  # scalar context beyond the territory
        if n < 4 * window_pad:
            return False  # too small for the split to be worthwhile

        # group ambiguous positions whose windows would overlap
        groups: list[list[int]] = []
        for p in amb_pos.tolist():
            if groups and p - groups[-1][1] <= 2 * window_pad:
                groups[-1][1] = p
            else:
                groups.append([p, p])

        # 1) scalar windows (emit blocks starting inside the territory)
        all_columns = []
        for first, last in groups:
            ws, we = max(0, first - window_pad), min(n, last + 1 + window_pad)
            ts = max(0, first - territory_pad)
            te = min(n, last + 1 + territory_pad)
            # a window clipped by the sequence edge has no edge effect there
            # (the full-sequence pyramid ends at the same place)
            all_columns.append(
                self._scalar_entry_arrays(codes[ws:we], lo, hi, offset=ws, keep=(ts, te))
            )
        if all_columns:
            self._emit_entry_arrays(
                tuple(np.concatenate(cols) for cols in zip(*all_columns)),
                seq_start, rc_start, n,
                by_size_keys, by_size_positions, by_size_amb,
            )

        # 2) clean segments between ambiguity groups (emit blocks starting
        # outside every territory)
        boundaries = [(max(0, f - territory_pad), min(n, l + 1 + territory_pad)) for f, l in groups]
        prev = 0
        for gi, (first, last) in enumerate(groups):
            if first > prev:
                self._hash_clean_segment(
                    codes, prev, first, gi, boundaries, lo, hi,
                    seq_start, rc_start, n,
                    by_size_keys, by_size_positions, by_size_amb,
                )
            prev = last + 1
        if prev < n:
            self._hash_clean_segment(
                codes, prev, n, len(groups), boundaries, lo, hi,
                seq_start, rc_start, n,
                by_size_keys, by_size_positions, by_size_amb,
            )
        return True

    def _hash_clean_segment(
        self, codes, s, e, group_index, boundaries, lo, hi,
        seq_start, rc_start, n,
        by_size_keys, by_size_positions, by_size_amb,
    ) -> None:
        """Hash clean stretch [s, e) standalone and emit blocks whose start
        falls outside the neighboring territories ([ts,te) intervals in
        ``boundaries``; the segment before group ``group_index`` is bounded by
        territories group_index-1 and group_index)."""
        keep_lo = boundaries[group_index - 1][1] if group_index > 0 else -(1 << 62)
        keep_hi = boundaries[group_index][0] if group_index < len(boundaries) else 1 << 62
        if self.enable_gapmers and os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
            from mapper_tpu_torch import native

            emitted = native.native_collect_emit_range(
                codes[s:e], s, n, keep_lo, keep_hi,
                self.min_interesting_size, lo, hi, seq_start, rc_start,
            )
            if emitted is not None:
                size_counts, keys, positions = emitted
                bounds = np.zeros(size_counts.shape[0] + 1, dtype=np.int64)
                np.cumsum(size_counts, out=bounds[1:])
                for size in np.nonzero(size_counts)[0].tolist():
                    sl = slice(bounds[size], bounds[size + 1])
                    by_size_keys.setdefault(size, []).append(keys[sl])
                    by_size_positions.setdefault(size, []).append(positions[sl])
                    by_size_amb.setdefault(size, []).append(
                        np.zeros(int(size_counts[size]), dtype=bool)
                    )
                return
        num_bp, fwd, rev, primary, secondary, start, length = self._collect_clean(
            codes[s:e], lo, hi
        )
        if num_bp.shape[0] == 0:
            return
        start = start + s
        keep = np.ones(start.shape[0], dtype=bool)
        if group_index > 0:
            keep &= start >= boundaries[group_index - 1][1]
        if group_index < len(boundaries):
            keep &= start < boundaries[group_index][0]
        if not np.any(keep):
            return
        self._emit(
            num_bp[keep], fwd[keep], rev[keep], primary[keep], secondary[keep],
            start[keep], length[keep],
            np.zeros(int(keep.sum()), dtype=bool),
            seq_start, rc_start, n,
            by_size_keys, by_size_positions, by_size_amb,
        )

    @staticmethod
    def _append(store: dict, size_arr, value_arr) -> None:
        sizes, inverse = np.unique(size_arr, return_inverse=True)
        for k, size in enumerate(sizes.tolist()):
            store.setdefault(size, []).append(value_arr[inverse == k])

    @staticmethod
    def _append_grouped(stores_and_values, size_arr) -> None:
        """Group several parallel value arrays by the shared size array with a
        single stable sort (np.unique per array was the index-build hotspot)."""
        order = np.argsort(size_arr, kind="stable")
        sorted_sizes = size_arr[order]
        distinct = np.nonzero(np.bincount(sorted_sizes))[0]
        bounds = np.searchsorted(sorted_sizes, np.append(distinct, distinct[-1] + 1))
        for store, values in stores_and_values:
            sv = values[order]
            for k, size in enumerate(distinct.tolist()):
                store.setdefault(size, []).append(sv[bounds[k] : bounds[k + 1]])

    def _emit(
        self,
        num_bp,
        fwd,
        rev,
        primary,
        secondary,
        start,
        length,
        amb,
        seq_start: int,
        rc_start: int,
        n: int,
        by_size_keys,
        by_size_positions,
        by_size_amb,
    ) -> None:
        """Dual-polarity insert (PackedMap.process, java:99-122): primary at the
        forward position with the forward hash, secondary at the
        reverse-complement position with the reverse hash."""
        sizes_all = []
        keys_all = []
        pos_all = []
        amb_all = []
        if np.any(primary):
            sizes_all.append(num_bp[primary])
            keys_all.append(fwd[primary])
            pos_all.append(seq_start + start[primary])
            amb_all.append(amb[primary])
        if np.any(secondary):
            sizes_all.append(num_bp[secondary])
            keys_all.append(rev[secondary])
            # RC position: rcStart + (n - blockEnd)   (PackedMap.java:113-117)
            pos_all.append(rc_start + n - (start[secondary] + length[secondary]))
            amb_all.append(amb[secondary])
        if not sizes_all:
            return
        sizes_cat = np.concatenate(sizes_all)
        keys_cat = np.concatenate(keys_all)
        pos_cat = np.concatenate(pos_all)
        amb_cat = np.concatenate(amb_all)
        self._append_grouped(
            [
                (by_size_keys, keys_cat),
                (by_size_positions, pos_cat),
                (by_size_amb, amb_cat),
            ],
            sizes_cat,
        )

    def merged_index(self):
        """A single cross-size view of all PackedIndex maps for one-gather
        batched lookups: per-size (capacity, bin base, cap) arrays plus the
        concatenation of all bin counts/offsets/values.  Rebuilt lazily after
        growth."""
        cached = getattr(self, "_merged_index_cache", None)
        if cached is not None and cached["through"] == self.max_fully_set_up_size:
            return cached
        max_size = self.max_fully_set_up_size
        capacities = np.ones(max_size + 2, dtype=np.int64)
        caps = np.zeros(max_size + 2, dtype=np.int64)
        bases = np.zeros(max_size + 2, dtype=np.int64)
        value_bases = np.zeros(max_size + 2, dtype=np.int64)
        counts_parts, offsets_parts, values_parts = [], [], []
        bin_cursor = 0
        value_cursor = 0
        for size in range(0, max_size + 1):
            m = self.maps.get(size)
            if m is None:
                from mapper_tpu_torch.index.packedmap import PackedIndex

                m = PackedIndex.empty(size)
            capacities[size] = m.capacity
            caps[size] = m.max_interesting_count
            bases[size] = bin_cursor
            value_bases[size] = value_cursor
            counts_parts.append(m.counts.astype(np.int64))
            offsets_parts.append(m.offsets[:-1] + value_cursor)
            values_parts.append(m.values)
            bin_cursor += m.capacity
            value_cursor += m.values.shape[0]
        exists = np.zeros(max_size + 2, dtype=np.uint8)
        for size in range(0, max_size + 1):
            if self.maps.get(size) is not None:
                exists[size] = 1
        cached = {
            "through": max_size,
            "capacities": capacities,
            "caps": caps,
            "bases": bases,
            # which sizes have a real map: lookups of a mapless size must
            # report INT_MAX (Readable_HashBlock_Database.java:72-80), which
            # the zero-filled empty-map bins cannot express
            "exists": exists,
            "counts": np.concatenate(counts_parts),
            "offsets": np.concatenate(offsets_parts),
            "values": np.concatenate(values_parts),
        }
        self._merged_index_cache = cached
        return cached

    # --- lookup (Readable_HashBlock_Database equivalents) ----------------

    def _map_for(self, num_basepairs_used: int) -> PackedIndex | None:
        if num_basepairs_used > self.max_fully_set_up_size:
            self.require_set_up_through_size(num_basepairs_used)
        return self.maps.get(num_basepairs_used)

    def num_matches_lower_bound(self, num_bp: int, lookup_key: int) -> int:
        """Readable_HashBlock_Database.getNumMatchesLowerBound (java:72-80)."""
        if num_bp < self.min_interesting_size:
            return _INT_MAX
        m = self._map_for(num_bp)
        if m is None:
            return _INT_MAX
        return int(m.num_matches_lower_bound(lookup_key))

    def get_max_num_matches_allowed(self, num_bp: int) -> int:
        """Readable_HashBlock_Database.getMaxNumMatchesAllowed (java:82-90)."""
        if num_bp < self.min_interesting_size:
            return -1
        m = self._map_for(num_bp)
        if m is None:
            return 0
        return m.max_interesting_count

    def match_block(
        self, num_bp: int, length: int, lookup_key: int, primary: bool
    ) -> np.ndarray | None:
        """Positions where a block matches (Readable_HashBlock_Database
        .matchBlock, java:19-38), as encoded global positions.  For secondary-
        polarity blocks, results are mapped to the reverse-complement strand
        using the block's total length."""
        if num_bp < self.min_interesting_size:
            return None
        m = self._map_for(num_bp)
        if m is None:
            return np.zeros(0, dtype=np.int64)
        results = m.get(lookup_key)
        if results is None:
            return None
        if not primary and len(results):
            results = self.reverse_complement_positions(results, length)
        return results

    def reverse_complement_positions(self, encoded: np.ndarray, block_length: int) -> np.ndarray:
        """Map encoded positions to the opposite strand
        (Readable_HashBlock_Database.reverseComplement, java:55-59)."""
        seq_idx, offsets = self.sequence_database.decode_positions(encoded)
        rc_idx = self._rc_index[seq_idx]
        if np.any(rc_idx < 0):
            raise KeyError("sequence without registered reverse complement")
        rc_offsets = self._seq_lengths[seq_idx] - offsets - block_length
        return self.sequence_database.starts[rc_idx] + rc_offsets

    def lookup_by_forward_hash(self, num_bp: int, bin_index: int) -> np.ndarray | None:
        """All positions in one bin plus their reverse complements
        (Readable_HashBlock_Database.lookupByForwardHash, java:41-52; used by
        the duplication scan)."""
        m = self._map_for(num_bp)
        if m is None:
            return None
        forward = m.get_bin(bin_index)
        if forward is None:
            return None
        if len(forward) == 0:
            return forward
        reverse = self.reverse_complement_positions(forward, num_bp)
        return np.concatenate([forward, reverse])

    def get_num_hash_keys(self, num_bp: int) -> int:
        m = self._map_for(num_bp)
        return 0 if m is None else m.capacity

    def verify_matches(self, other: "HashBlockDatabase") -> None:
        """Determinism audit (HashBlock_Database.verifyMatches, java:468-475)."""
        other.require_set_up_through_size(self.max_fully_set_up_size)
        for size in range(self.min_interesting_size, self.max_fully_set_up_size + 1):
            self.maps[size].verify_matches(other.maps[size])
