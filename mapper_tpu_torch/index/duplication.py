"""Duplication detection over the hashblock index.

Equivalent of the reference's DuplicationDetector + Readable_DuplicationDetector
(DuplicationDetector.java): scan every hash bin of every block size in
[minDuplicationLength, maxDuplicationLength]; any bin whose positions share the
same block-edge text in >= minNumInterestingCopies places is a duplication.
Only "interesting" duplications (not containing another duplication) are kept,
with windowed pruning (saveDuplications/compareDuplications, java:332-436).

The per-bin scan is driven by the packed index's bin counts, so only bins with
enough entries are visited (vectorized selection); the edge-text grouping that
kills hash collisions (java:182-199) gathers from the concatenated reference
array.

The resulting per-sequence position sets power the early-accept proof
(AlignerWorker.quicklyConfidentInBestAlignment, AlignerWorker.java:494-587) —
"is there any duplication near this match?" — via sorted-array bisection.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from mapper_tpu_torch import basepairs, trace
from mapper_tpu_torch.native import dupscan as native_dupscan
from mapper_tpu_torch.sequence import Sequence, SequenceDatabase


@dataclass
class Duplication:
    """A group of reference positions sharing identical block-edge text
    (Duplication.java)."""

    length: int
    positions: list[int] = field(default_factory=list)  # encoded global positions

    @property
    def num_instances(self) -> int:
        return len(self.positions)


class DuplicationDetector:
    def __init__(
        self,
        hashblock_database,
        min_duplication_length: int | None = None,
        max_duplication_length: int | None = None,
        min_num_interesting_copies: int = 2,
        window_size: int = 1,
        cache_dir=None,
        tracer=trace.OFF,
    ):
        from mapper_tpu_torch.index.database import (
            choose_max_duplication_length,
            choose_min_duplication_length,
        )

        self.database = hashblock_database
        seq_db = hashblock_database.get_sequence_database()
        self.sequence_database: SequenceDatabase = seq_db
        if min_duplication_length is None:
            min_duplication_length = choose_min_duplication_length(seq_db)
        if max_duplication_length is None:
            max_duplication_length = choose_max_duplication_length(seq_db)
        self.min_size = min_duplication_length
        self.max_size = max_duplication_length
        self.min_num_interesting_copies = min_num_interesting_copies
        self.window_size = window_size
        self.enable_gapmers = hashblock_database.get_enable_gapmers()
        self.tracer = tracer
        self._detected = False
        # per sequence index: sorted list of (startIndex, Duplication)
        self._by_sequence: dict[int, list[tuple[int, Duplication]]] = {}
        self._starts_by_sequence: dict[int, list[int]] = {}

    # --- interface used by the early-accept proof -------------------------

    def get_detection_granularity(self) -> float:
        """DuplicationDetector.getDetectionGranularity (java:67-77)."""
        if self.enable_gapmers:
            return self.min_size * 5 // 8
        return self.min_size

    def get_window_number(self, index: int) -> int:
        if self.window_size <= 1:
            return index
        return index // self.window_size

    def may_contain_duplication_in_range(
        self, sequence: Sequence, start_index: int, end_index: int
    ) -> int | None:
        """Readable_DuplicationDetector.mayContainDuplicationInRange
        (java:28-47)."""
        self.ensure_detected()
        # unknown sequences find nothing, exactly like the reference's
        # HashMap.get returning null (Readable_DuplicationDetector.java:20-33)
        # — under --infer-ancestors the worker probes with the ORIGINAL contig
        # while this detector indexes the ancestral database's sequences
        seq_idx = self.sequence_database.index_of_or_none(sequence)
        if seq_idx is None:
            return None
        starts = self._starts_by_sequence.get(seq_idx)
        if not starts:
            return None
        window_start = self.get_window_number(start_index)
        window_end = self.get_window_number(end_index)
        # floorEntry(end_index)
        i = bisect.bisect_right(starts, end_index) - 1
        if i >= 0:
            w = self.get_window_number(starts[i])
            if window_start <= w <= window_end:
                return starts[i]
        # ceilingEntry(start_index)
        j = bisect.bisect_left(starts, start_index)
        if j < len(starts):
            w = self.get_window_number(starts[j])
            if window_start <= w <= window_end:
                return starts[j]
        return None

    def get_interesting_duplications_on_sequence(self, sequence: Sequence):
        self.ensure_detected()
        seq_idx = self.sequence_database.index_of_or_none(sequence)
        if seq_idx is None:
            return []
        return self._by_sequence.get(seq_idx, [])

    def get_all(self) -> list[Duplication]:
        self.ensure_detected()
        seen: dict[int, Duplication] = {}
        for entries in self._by_sequence.values():
            for _, dup in entries:
                seen[id(dup)] = dup
        return list(seen.values())

    def help_setup(self) -> None:
        self.ensure_detected()

    # --- detection --------------------------------------------------------

    def ensure_detected(self) -> None:
        if self._detected:
            return
        self._detected = True
        if self._load_from_cache():
            return
        self.database.require_set_up_through_size(self.min_size + 1)
        concat = self.sequence_database.concatenated_codes()
        for block_length in range(self.min_size, self.max_size + 1):
            self._process_length(block_length, concat)
        # build the sorted-start arrays for bisection
        for seq_idx, entries in self._by_sequence.items():
            entries.sort(key=lambda e: e[0])
            self._starts_by_sequence[seq_idx] = [start for start, _ in entries]
        self._save_to_cache()

    # --- disk cache (the reference persists per-length duplication files in
    # its DirCache; DuplicationDetector.java:286-330,448-469) ----------------

    def _cache_file(self) -> str | None:
        content_dir = getattr(self.database, "_cache_content_dir", None)
        if content_dir is None:
            return None
        import os

        name = (
            f"duplications-{self.min_size}-{self.max_size}"
            f"-{self.min_num_interesting_copies}-{self.window_size}.npz"
        )
        return os.path.join(content_dir, name)

    def _save_to_cache(self) -> None:
        path = self._cache_file()
        if path is None:
            return
        lengths, counts, flat_positions = [], [], []
        seen: dict[int, int] = {}
        dups: list[Duplication] = []
        for entries in self._by_sequence.values():
            for _, dup in entries:
                if id(dup) not in seen:
                    seen[id(dup)] = len(dups)
                    dups.append(dup)
        for dup in dups:
            lengths.append(dup.length)
            counts.append(len(dup.positions))
            flat_positions.extend(dup.positions)
        np.savez_compressed(
            path,
            lengths=np.array(lengths, dtype=np.int64),
            counts=np.array(counts, dtype=np.int64),
            positions=np.array(flat_positions, dtype=np.int64),
        )

    def _load_from_cache(self) -> bool:
        path = self._cache_file()
        if path is None:
            return False
        import os

        if not os.path.exists(path):
            return False
        try:
            data = np.load(path)
        except Exception:
            return False
        lengths = data["lengths"]
        counts = data["counts"]
        positions = data["positions"]
        pending: list[tuple[int, Duplication]] = []
        cursor = 0
        for i in range(lengths.shape[0]):
            count = int(counts[i])
            dup = Duplication(
                int(lengths[i]), positions[cursor : cursor + count].tolist()
            )
            cursor += count
            for pos in dup.positions:
                pending.append((pos, dup))
        self._insert(pending)
        for seq_idx, entries in self._by_sequence.items():
            entries.sort(key=lambda e: e[0])
            self._starts_by_sequence[seq_idx] = [start for start, _ in entries]
        return True

    def _process_length(self, block_length: int, concat: np.ndarray) -> None:
        """DuplicationDetector.process (java:129-213) for one block size."""
        m = self.database._map_for(block_length)
        if m is None or m.capacity == 0:
            return
        # one native pass groups the bins; the vectorized pass below is its
        # fallback where the library cannot be built or refuses the input
        if self._process_length_native(block_length, m, concat):
            return
        # bins with >= minCopies stored forward positions and not overflowed
        interesting = np.nonzero(
            (m.counts >= self.min_num_interesting_copies)
            & (m.counts <= m.max_interesting_count)
        )[0]
        if interesting.shape[0] == 0:
            return
        prefix_length = (block_length + 3) // 4
        amb = basepairs.TWO_BIT_TABLE[concat] < 0
        pending: list[tuple[int, Duplication]] = []

        # one vectorized pass over ALL interesting bins (per-bin np.unique
        # calls were the detection hotspot): CSR-gather every stored forward
        # position, add reverse complements, group rows by (bin, edge text),
        # then dedup positions within each group.
        bin_counts = (m.offsets[interesting + 1] - m.offsets[interesting]).astype(np.int64)
        total = int(bin_counts.sum())
        if total == 0:
            return
        self.tracer.count("dupscan.rows", 2 * total)
        row_bin = np.repeat(np.arange(interesting.shape[0], dtype=np.int64), bin_counts)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(bin_counts) - bin_counts, bin_counts
        )
        forward = m.values[np.repeat(m.offsets[interesting], bin_counts) + within]
        reverse = self.database.reverse_complement_positions(forward, block_length)
        matches = np.concatenate([forward, reverse])
        bins = np.concatenate([row_bin, row_bin])

        # group by edge text (prefix + suffix) to kill collisions
        idx_prefix = matches[:, None] + np.arange(prefix_length, dtype=np.int64)[None, :]
        idx_suffix = (
            matches[:, None]
            + (block_length - prefix_length)
            + np.arange(prefix_length, dtype=np.int64)[None, :]
        )
        keep = ~(amb[idx_prefix].any(axis=1) | amb[idx_suffix].any(axis=1))
        if not np.any(keep):
            return
        combined = np.empty((int(keep.sum()), 1 + 2 * prefix_length), dtype=np.int32)
        combined[:, 0] = bins[keep]
        combined[:, 1 : 1 + prefix_length] = concat[idx_prefix[keep]]
        combined[:, 1 + prefix_length :] = concat[idx_suffix[keep]]
        kept_matches = matches[keep]
        # rows sorted by (bin, text) reproduce the sequential loop's group
        # order: bins ascending, np.unique's lexicographic text order within
        _, group_ids = np.unique(combined, axis=0, return_inverse=True)
        group_ids = group_ids.reshape(-1)

        order = np.lexsort((kept_matches, group_ids))
        g_s = group_ids[order]
        p_s = kept_matches[order]
        uniq = np.ones(g_s.shape[0], dtype=bool)
        uniq[1:] = (g_s[1:] != g_s[:-1]) | (p_s[1:] != p_s[:-1])
        g_u = g_s[uniq]
        p_u = p_s[uniq]
        starts = np.nonzero(np.r_[True, g_u[1:] != g_u[:-1]])[0]
        ends = np.r_[starts[1:], g_u.shape[0]]
        sizes = ends - starts
        for k in np.nonzero(sizes >= self.min_num_interesting_copies)[0].tolist():
            dup = Duplication(block_length, p_u[starts[k] : ends[k]].tolist())
            for pos in dup.positions:
                pending.append((pos, dup))
        self._insert(pending)

    def _process_length_native(self, block_length: int, m, concat: np.ndarray) -> bool:
        """The vectorized pass's groups from one native call
        (native/dupscan.cpp), in its order, handed to `_insert` as it hands
        them; False, with nothing done, where the library is unavailable or
        refuses the input."""
        grouped = native_dupscan.group(
            m, self.min_num_interesting_copies, block_length, concat,
            self.sequence_database.starts, self.database._seq_lengths, self.database._rc_index,
        )
        if grouped is None:
            return False
        rows, sizes, positions = grouped
        self.tracer.count("dupscan.rows", rows)
        self.tracer.count("dupscan.native_rows", rows)
        positions = positions.tolist()
        pending: list[tuple[int, Duplication]] = []
        cursor = 0
        for size in sizes.tolist():
            dup = Duplication(block_length, positions[cursor : cursor + size])
            cursor += size
            for pos in dup.positions:
                pending.append((pos, dup))
        self._insert(pending)
        return True

    def _insert(self, pending: list[tuple[int, Duplication]]) -> None:
        """saveDuplications (java:332-400): maintain, per sequence, the set of
        duplications such that none contains another, with windowed pruning."""
        seq_starts = self.sequence_database.starts
        for encoded, dup in pending:
            seq_idx = int(np.searchsorted(seq_starts, encoded, side="right")) - 1
            start = int(encoded - seq_starts[seq_idx])
            entries = self._by_sequence.setdefault(seq_idx, [])
            # persistent parallel starts list (rebuilding it per inserted
            # position made saveDuplications quadratic on repeat-rich data);
            # every del/insert below mutates both lists in lockstep
            starts = self._starts_by_sequence.get(seq_idx)
            if starts is None or len(starts) != len(entries):
                starts = self._starts_by_sequence[seq_idx] = [e[0] for e in entries]
            insert = True
            # remove worse neighbors below (floor side)
            while True:
                i = bisect.bisect_right(starts, start) - 1
                if i >= 0:
                    cmp = self._compare(start, dup, starts[i], entries[i][1])
                    if cmp > 0:
                        insert = False
                        break
                    if cmp < 0:
                        del entries[i]
                        del starts[i]
                        continue
                break
            if insert:
                while True:
                    j = bisect.bisect_left(starts, start)
                    if j < len(starts):
                        cmp = self._compare(start, dup, starts[j], entries[j][1])
                        if cmp > 0:
                            insert = False
                            break
                        if cmp < 0:
                            del entries[j]
                            del starts[j]
                            continue
                    break
            if insert:
                k = bisect.bisect_left(starts, start)
                if k < len(starts) and starts[k] == start:
                    entries[k] = (start, dup)
                else:
                    entries.insert(k, (start, dup))
                    starts.insert(k, start)

    def _compare(self, start1: int, dup1: Duplication, start2: int, dup2: Duplication) -> int:
        """compareDuplications (java:406-436): positive means dup2 is better."""
        if self.window_size > 1:
            if self.get_window_number(start1) != self.get_window_number(start2):
                return 0
        end1 = start1 + dup1.length
        end2 = start2 + dup2.length
        if start1 <= start2 and end1 >= end2:
            return 1  # dup2 is more specific
        if start1 >= start2 and end1 <= end2:
            return -1  # dup1 is more specific
        if self.window_size > 1:
            diff = dup1.num_instances - dup2.num_instances
            if diff != 0:
                return diff
            if start1 != start2:
                return start1 - start2
        return 0
