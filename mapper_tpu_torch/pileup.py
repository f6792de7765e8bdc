"""Per-position pileup accumulation (reference: QuickVariants MatchDatabase /
Alignments / AlignmentPosition; API reconstructed from usage at
Mapper.java:700,760-784 and MatchDatabase_Test.java).

Semantics:
- every aligned query base contributes weight to its reference position's
  allele counter; a query with N alternative alignments contributes 1/N to
  each; overlapping paired-end mates contribute 0.5 each in the overlapping
  reference range so the overlap has total weight 1
  (MatchDatabase_Test.testOverlappingPairedEndQueries);
- bases within `query_end_fraction` of either end of a read are tracked
  separately ("end" vs "middle" depth; --distinguish-query-ends);
- deletions add weight to a deletion allele per deleted reference position
  (start and continuation tracked separately); insertions are recorded at the
  reference position they precede, keyed by the inserted text;
- alignments against reverse-strand contigs are folded onto the forward
  contig's coordinates.

TPU-first: the accumulators are flat per-contig arrays filled with
np.add.at scatter-adds (device version: segment-sums over the batch, psum over
the data-parallel mesh), so merging shards is pure addition.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mapper_tpu_torch import basepairs, trace
from mapper_tpu_torch.align.blocks import QueryAlignment, QueryAlignments
from mapper_tpu_torch.native import pileup as native_pileup
from mapper_tpu_torch.sequence import Sequence

# allele rows in the count arrays
ROW_A, ROW_C, ROW_G, ROW_T, ROW_AMB, ROW_DEL = range(6)

_CODE_TO_ROW = np.full(16, ROW_AMB, dtype=np.int8)
_CODE_TO_ROW[basepairs.A] = ROW_A
_CODE_TO_ROW[basepairs.C] = ROW_C
_CODE_TO_ROW[basepairs.G] = ROW_G
_CODE_TO_ROW[basepairs.T] = ROW_T

ROW_CHARS = "ACGTN-"


@dataclass
class ContigPileup:
    sequence: Sequence
    # [6, len] float64: middle-of-read allele weights / end-of-read weights
    middle: np.ndarray
    end: np.ndarray
    # deletion starts (first deleted position) middle-of-read weight
    deletion_start_middle: np.ndarray
    # insertions keyed by (position, inserted text) -> [middle_w, end_w, example]
    insertions: dict[tuple[int, str], list] = field(default_factory=dict)

    @staticmethod
    def empty(sequence: Sequence) -> "ContigPileup":
        n = len(sequence)
        return ContigPileup(
            sequence,
            np.zeros((6, n)),
            np.zeros((6, n)),
            np.zeros(n),
        )

    def get_count(self, position: int) -> float:
        """AlignmentPosition.getCount(): total aligned weight at a position
        (excluding deletions)."""
        return float(
            self.middle[:ROW_DEL, position].sum() + self.end[:ROW_DEL, position].sum()
        )

    def total_depth(self, position: int) -> float:
        return float(self.middle[:, position].sum() + self.end[:, position].sum())

    def middle_depth(self, position: int) -> float:
        return float(self.middle[:, position].sum())


class MatchDatabase:
    """Accumulates QueryAlignments; groupByPosition() returns per-forward-contig
    pileups."""

    def __init__(self, query_end_fraction: float = 0.1):
        self.query_end_fraction = query_end_fraction
        self.pileups: dict[int, ContigPileup] = {}
        self._pending: list[QueryAlignments] = []
        self._buffers: dict[int, list] = {}
        self._fast: list = []
        self._grouped = False
        self._contig_order: dict[int, int] | None = None

    def set_contig_order(self, sequences) -> None:
        """Canonical contig output order (the reference database order):
        makes group_by_position's ordering independent of which accumulation
        path (host scatter vs device merge) first touched each contig."""
        sequences = list(sequences)
        self._contig_order = {id(s): i for i, s in enumerate(sequences)}
        self._contig_sequences = sequences

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        self._pending.extend(results)

    def group_by_position(self, tracer=trace.OFF) -> dict[Sequence, ContigPileup]:
        # one native pass adds every pending alignment; the Python passes
        # below are the fallback where the library cannot be built
        if not self._accumulate_native(tracer):
            self._buffers: dict[int, list] = {}
            self._fast: list = []
            for query_alignments in self._pending:
                self._accumulate(query_alignments)
            self._flush_fast()
            self._flush_buffers()
        self._pending = []
        pileups = list(self.pileups.values())
        if self._contig_order is not None:
            order = self._contig_order
            pileups.sort(key=lambda p: order.get(id(p.sequence), len(order)))
        return {p.sequence: p for p in pileups}

    def _accumulate_native(self, tracer) -> bool:
        """Adds every pending alignment in one native pass
        (native/pileup.cpp), bit for bit as the Python passes do, with no
        Sequence object and no numpy call per read or block: the engine's
        lazy rows and the other alignments' blocks go in as flat tables, and
        only the insertions come back to `_add_insertion`.  Counts the
        component alignments (`pileup.alignments`) and those the pass took
        (`pileup.native`).  False, with nothing written, where the library
        is unavailable or an array or index does not fit."""
        entries: dict[int, int] = {}  # id(reference sequence) -> entry
        entry_contig: list[int] = []
        entry_folded: list[bool] = []
        contigs: dict[int, int] = {}  # id(forward sequence) -> contig
        forwards: list[Sequence] = []
        code_parts: list[np.ndarray] = []
        num_codes = 0
        records: list[int] = []  # native_pileup.FIELDS an alignment, in visit order
        blocks: list[int] = []  # (start_a, start_b, length_a, length_b) each
        insertions: list = []  # (record, alignment, block) of each insertion

        def entry_of(ref: Sequence) -> int:
            entry = entries.get(id(ref))
            if entry is None:
                fwd = ref.complemented_from
                entry_folded.append(fwd is not None)
                fwd = ref if fwd is None else fwd
                contig = contigs.get(id(fwd))
                if contig is None:
                    contig = contigs[id(fwd)] = len(forwards)
                    forwards.append(fwd)
                entry_contig.append(contig)
                entry = entries[id(ref)] = len(entry_contig) - 1
            return entry

        lazy, first_mate = native_pileup.LAZY, native_pileup.FIRST_MATE
        last_ref, last_entry = None, -1
        for query_alignments in self._pending:
            # results already counted by the batch engine's DevicePileup
            if query_alignments.device_counted:
                continue
            rows = getattr(query_alignments, "rows", None)
            if rows is not None and query_alignments.alignments_per_component is None:
                # the engine's LazyUngappedAlignments: one full-length block
                # a row, the read's codes reverse-complemented natively
                codes = query_alignments.query_sequences[0].codes
                length = len(codes)
                code_parts.append(codes)
                choices = len(rows)
                for rev, ref, off, _pen in rows:
                    if ref is not last_ref:
                        last_ref, last_entry = ref, entry_of(ref)
                    records += (num_codes, length, lazy | rev, last_entry, choices, off)
                num_codes += length
                continue
            for component_alignments in query_alignments.get_alignments():
                choices = len(component_alignments)
                for choice in component_alignments:
                    components = choice.components
                    mate = first_mate if len(components) == 2 else 0
                    for seq_alignment in components:
                        sections = seq_alignment.sections
                        codes = sections[0].sequence_a.codes
                        code_parts.append(codes)
                        ref = sections[0].sequence_b
                        if ref is not last_ref:
                            last_ref, last_entry = ref, entry_of(ref)
                        records += (num_codes, len(codes), mate, last_entry, choices, len(sections))
                        num_codes += len(codes)
                        mate += mate
                        for block in sections:
                            blocks += (block.start_a, block.start_b, block.length_a, block.length_b)
                            if block.length_b == 0 and block.length_a > 0:
                                insertions.append((len(records) // native_pileup.FIELDS - 1, seq_alignment, block))

        num = len(records) // native_pileup.FIELDS
        tracer.count("pileup.alignments", num)
        if num:
            # new pileups join self.pileups once the pass has run, in the
            # order the Python passes would have made them
            pileups = []
            for fwd in forwards:
                pileup = self.pileups.get(id(fwd))
                pileups.append(ContigPileup.empty(fwd) if pileup is None else pileup)
            out = native_pileup.accumulate(
                pileups, [self._ref_rows(p) for p in pileups], entry_contig, entry_folded,
                b"".join(code_parts), _CODE_TO_ROW, basepairs.COMPLEMENT_TABLE, self.query_end_fraction,
                records, blocks,
            )
            if out is None:
                tracer.count("pileup.native", 0)
                return False
            overlap_lo, overlap_hi, order = out
            for contig in order:
                self.pileups.setdefault(id(forwards[contig]), pileups[contig])
            # insertions, keyed by their text, in visit order
            for k, seq_alignment, block in insertions:
                lo, hi = int(overlap_lo[k]), int(overlap_hi[k])
                weight = 1.0 / records[native_pileup.FIELDS * k + 4]
                self._add_insertion(seq_alignment, block, weight, (lo, hi) if lo >= 0 else None)
        tracer.count("pileup.native", num)
        return True

    def _flush_fast(self) -> None:
        """Columnar accumulation of the dominant alignment shape — one
        full-length ungapped block, no mate overlap (what the batch engine
        emits).

        Differential trick: a clean ungapped read's contribution is a *range*
        of depth whose allele equals the reference base everywhere except at
        its few mismatches.  So instead of scattering one point per aligned
        base (O(read_len) per read), add the read as two endpoints in a
        per-contig difference array (prefix-summed once per flush into the
        reference-allele rows) plus sparse corrections where the read row
        differs from the reference row — O(1 + mismatches) per read, ~100x
        fewer scatter points at 1% SNP.  Exact for power-of-two weights (the
        prefix sums and cancellations stay exact in float64); other weights
        (1/3-choice reads etc.) keep the direct per-base scatter so float
        results are identical to the per-block path."""
        groups: dict[tuple, list] = {}
        # _fast items: (query_codes, start_b, ref_sequence, weight) — appended
        # either from materialized SequenceAlignments or directly from the
        # batch engine's columnar LazyUngappedAlignments rows
        for qcodes, start_b, ref, weight in self._fast:
            folded = ref.complemented_from is not None
            fwd = ref.complemented_from if folded else ref
            # weight in the key: nearly everything is weight 1.0, and a
            # uniform weight makes the scatter-add take a scalar
            groups.setdefault((id(fwd), folded, qcodes.shape[0], weight), []).append(
                (qcodes, start_b, ref)
            )
        self._fast = []
        # per-contig difference arrays, filled across groups, summed once
        diffs: dict[int, tuple] = {}  # id(pileup) -> (pileup, diff_mid, diff_end)
        for (_, folded, length, weight), items in groups.items():
            ref = items[0][2]
            pileup = self._pileup_for(ref)
            ref_len = len(ref)
            n = pileup.middle.shape[1]
            # int32 indices halve the scatter traffic; contigs past ~350 Mb
            # (6 rows x length) need int64
            idt = np.int32 if 6 * n < 2**31 - 1 else np.int64
            codes = np.stack([it[0][:length] for it in items])
            starts = np.array([it[1] for it in items], dtype=idt)
            if folded:
                codes = basepairs.COMPLEMENT_TABLE[codes]
            rows = _CODE_TO_ROW[codes].astype(idt)
            # the end-of-read mask is symmetric and contiguous at both read
            # ends: [0, lo) and [length - lo, length)
            j = np.arange(length)
            is_end = np.minimum(j, length - 1 - j) < self.query_end_fraction * length
            lo = int(np.argmin(is_end)) if not is_end.all() else length

            import math

            dyadic = weight > 0 and math.frexp(weight)[0] == 0.5
            if dyadic and 2 * lo < length:
                key = id(pileup)
                entry = diffs.get(key)
                if entry is None:
                    entry = diffs[key] = (
                        pileup,
                        np.zeros(n + 1),
                        np.zeros(n + 1),
                    )
                _, diff_mid, diff_end = entry
                # forward-contig start of the read's window (folding maps the
                # descending positions onto the same contiguous range)
                fwd_start = (
                    (ref_len - starts - length).astype(np.int64)
                    if folded
                    else starts.astype(np.int64)
                )
                # end ranges [s, s+lo) and [s+length-lo, s+length);
                # middle range [s+lo, s+length-lo)
                np.add.at(diff_mid, fwd_start + lo, weight)
                np.add.at(diff_mid, fwd_start + length - lo, -weight)
                if lo:
                    np.add.at(diff_end, fwd_start, weight)
                    np.add.at(diff_end, fwd_start + lo, -weight)
                    np.add.at(diff_end, fwd_start + length - lo, weight)
                    np.add.at(diff_end, fwd_start + length, -weight)
                # sparse corrections where the read row differs from the
                # reference row (reference rows are cached on the pileup)
                rref = self._ref_rows(pileup)
                positions = starts[:, None] + np.arange(length, dtype=idt)[None, :]
                if folded:
                    positions = idt(ref_len - 1) - positions
                mism = rows != rref[positions]
                if mism.any():
                    mid_mask = np.zeros(length, dtype=bool)
                    mid_mask[lo : length - lo] = True
                    for target, mask in (
                        (pileup.middle, mism & mid_mask[None, :]),
                        (pileup.end, mism & ~mid_mask[None, :]),
                    ):
                        if not mask.any():
                            continue
                        pos_m = positions[mask].astype(np.int64)
                        flat = target.reshape(-1)
                        np.add.at(
                            flat, rows[mask].astype(np.int64) * n + pos_m, weight
                        )
                        np.add.at(
                            flat,
                            rref[positions[mask]].astype(np.int64) * n + pos_m,
                            -weight,
                        )
                continue

            positions = starts[:, None] + np.arange(length, dtype=idt)[None, :]
            if folded:
                positions = idt(ref_len - 1) - positions
            flat = rows * idt(n) + positions
            middle_flat = pileup.middle.reshape(-1)
            np.add.at(middle_flat, flat[:, lo : length - lo].reshape(-1), weight)
            if lo:
                end_flat = pileup.end.reshape(-1)
                np.add.at(end_flat, flat[:, :lo].reshape(-1), weight)
                np.add.at(end_flat, flat[:, length - lo :].reshape(-1), weight)

        # one prefix-sum per touched contig turns the difference arrays into
        # depth, added onto each position's reference-allele row
        for pileup, diff_mid, diff_end in diffs.values():
            n = pileup.middle.shape[1]
            rref = self._ref_rows(pileup)
            cols = np.arange(n)
            depth_mid = np.cumsum(diff_mid[:-1])
            pileup.middle[rref, cols] += depth_mid
            depth_end = np.cumsum(diff_end[:-1])
            pileup.end[rref, cols] += depth_end

    def _ref_rows(self, pileup: ContigPileup) -> np.ndarray:
        """Cached allele-row of each reference base of a forward contig."""
        rref = getattr(pileup, "_ref_rows", None)
        if rref is None:
            rref = _CODE_TO_ROW[pileup.sequence.codes]
            pileup._ref_rows = rref
        return rref

    def _flush_buffers(self) -> None:
        """One scatter-add per accumulator array instead of one per block:
        the buffered triplets are concatenated in visit order, so the float
        addition order (and thus every bit of the result) matches the
        per-block scatters exactly."""
        for key, buf in self._buffers.items():
            pileup = self.pileups[key]
            n = pileup.middle.shape[1]
            for target, triplets in ((pileup.middle, buf[0]), (pileup.end, buf[1])):
                if not triplets:
                    continue
                rows = np.concatenate([t[0] for t in triplets])
                positions = np.concatenate([t[1] for t in triplets])
                weights = np.concatenate([t[2] for t in triplets])
                np.add.at(
                    target.reshape(-1), rows.astype(np.int64) * n + positions, weights
                )
            for position, w in buf[2]:
                pileup.deletion_start_middle[position] += w
        self._buffers = {}

    # --- accumulation -----------------------------------------------------

    def _pileup_for(self, sequence: Sequence) -> ContigPileup:
        # fold RC contigs onto their forward sequence
        if sequence.complemented_from is not None:
            sequence = sequence.complemented_from
        key = id(sequence)
        if key not in self.pileups:
            self.pileups[key] = ContigPileup.empty(sequence)
        return self.pileups[key]

    def _buffer_for(self, key: int) -> list:
        buf = self._buffers.get(key)
        if buf is None:
            buf = [[], [], []]  # middle triplets, end triplets, deletion starts
            self._buffers[key] = buf
        return buf

    def _accumulate(self, query_alignments: QueryAlignments) -> None:
        # results already counted by the batch engine's DevicePileup
        # scatter-adds (batch/device_pileup.py) skip host accumulation
        if getattr(query_alignments, "device_counted", False):
            return
        rows = getattr(query_alignments, "rows", None)
        if rows is not None and query_alignments.alignments_per_component is None:
            # columnar fast intake for the batch engine's
            # LazyUngappedAlignments (full-length single-block ungapped, no
            # mate overlap by construction) — same records _accumulate_choice
            # would have queued, without materializing the objects
            seq = query_alignments.query_sequences[0]
            weight = 1.0 / len(rows)
            for rev, ref, off, _pen in rows:
                seq_a = seq.reverse_complement() if rev else seq
                self._fast.append((seq_a.codes, off, ref, weight))
            return
        for component_alignments in query_alignments.get_alignments():
            n_choices = len(component_alignments)
            if n_choices == 0:
                continue
            weight = 1.0 / n_choices
            for choice in component_alignments:
                self._accumulate_choice(choice, weight)

    def _accumulate_choice(self, choice: QueryAlignment, weight: float) -> None:
        components = choice.get_components()
        # overlapping mates: weight 0.5 in the shared reference range
        overlap_range = None
        if len(components) == 2:
            a, b = components
            if a.get_sequence_b() is b.get_sequence_b():
                lo = max(a.get_start_index_b(), b.get_start_index_b())
                hi = min(a.get_end_index_b(), b.get_end_index_b())
                if lo < hi:
                    overlap_range = (lo, hi)
        for seq_alignment in components:
            sections = seq_alignment.sections
            if (
                overlap_range is None
                and len(sections) == 1
                and sections[0].length_a == sections[0].length_b
                and sections[0].start_a == 0
                and sections[0].length_a == len(seq_alignment.get_sequence_a())
            ):
                self._fast.append(
                    (
                        seq_alignment.get_sequence_a().codes,
                        sections[0].start_b,
                        seq_alignment.get_sequence_b(),
                        weight,
                    )
                )
            else:
                self._accumulate_sequence(seq_alignment, weight, overlap_range)

    def _accumulate_sequence(self, alignment, weight: float, overlap_range) -> None:
        query = alignment.get_sequence_a()
        ref = alignment.get_sequence_b()
        self._pileup_for(ref)  # made here, in visit order
        buf = self._buffer_for(
            id(ref.complemented_from if ref.complemented_from is not None else ref)
        )
        folded = ref.complemented_from is not None
        ref_len = len(ref)
        query_len = len(query)
        end_margin = self.query_end_fraction * query_len

        def fold_pos(pos: np.ndarray | int):
            if folded:
                return ref_len - 1 - pos
            return pos

        def fold_codes(codes: np.ndarray):
            if folded:
                return basepairs.COMPLEMENT_TABLE[codes]
            return codes

        for block in alignment.sections:
            if block.length_a == block.length_b and block.length_a > 0:
                q_idx = np.arange(block.start_a, block.end_a)
                r_idx = np.arange(block.start_b, block.end_b)
                codes = fold_codes(query.codes[q_idx])
                rows = _CODE_TO_ROW[codes]
                positions = fold_pos(r_idx)
                dist_from_end = np.minimum(q_idx, query_len - 1 - q_idx)
                is_end = dist_from_end < end_margin
                w = np.full(len(q_idx), weight)
                if overlap_range is not None:
                    in_overlap = (r_idx >= overlap_range[0]) & (r_idx < overlap_range[1])
                    w = np.where(in_overlap, weight * 0.5, w)
                buf[0].append((rows[~is_end], positions[~is_end], w[~is_end]))
                buf[1].append((rows[is_end], positions[is_end], w[is_end]))
            elif block.length_b > 0:
                # deletion: weight per deleted reference position
                r_idx = np.arange(block.start_b, block.end_b)
                q_pos = block.start_a
                dist_from_end = min(q_pos, query_len - q_pos)
                is_end = dist_from_end < end_margin
                positions = fold_pos(r_idx)
                w = np.full(len(r_idx), weight)
                if overlap_range is not None:
                    in_overlap = (r_idx >= overlap_range[0]) & (r_idx < overlap_range[1])
                    w = np.where(in_overlap, weight * 0.5, w)
                buf[1 if is_end else 0].append(
                    (np.full(len(r_idx), ROW_DEL), positions, w)
                )
                if not is_end:
                    # mark the deletion start (leftmost folded coordinate)
                    buf[2].append((int(positions.min()), w[0]))
            elif block.length_a > 0:
                self._add_insertion(alignment, block, weight, overlap_range)

    def _add_insertion(self, alignment, block, weight: float, overlap_range) -> None:
        """An insertion block: its weight recorded at the forward position it
        precedes, keyed by the inserted text (the Python passes and the
        native pass both)."""
        query = alignment.get_sequence_a()
        ref = alignment.get_sequence_b()
        pileup = self._pileup_for(ref)
        folded = ref.complemented_from is not None
        inserted = query.codes[block.start_a : block.end_a]
        if folded:
            inserted = basepairs.COMPLEMENT_TABLE[inserted][::-1]
            position = len(ref) - block.start_b
        else:
            position = block.start_b
        text = basepairs.decode(inserted)
        query_len = len(query)
        mid_q = block.start_a
        dist_from_end = min(mid_q, query_len - mid_q)
        is_end = dist_from_end < self.query_end_fraction * query_len
        w = weight
        if overlap_range is not None and (
            overlap_range[0] <= block.start_b < overlap_range[1]
        ):
            w = weight * 0.5
        # 4th element: global query id of the first contributor, so
        # multi-process merges can keep the 1-process example read
        entry = pileup.insertions.setdefault(
            (position, text), [0.0, 0.0, query.name, query.identifier]
        )
        if is_end:
            entry[1] += w
        else:
            entry[0] += w
