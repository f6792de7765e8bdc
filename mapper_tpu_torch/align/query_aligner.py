"""Per-candidate alignment driver: budgets, paired-end spacing and overlap
penalty algebra.

Faithful port of the reference's QueryMatch_Aligner (QueryMatch_Aligner.java):

- window computation per candidate (alignMatch, java:412-443),
- spacing penalty from the inner-distance model (computeSpacingPenalty,
  java:530-546),
- overlapping mates: join into one sequence when the overlap region is
  byte-identical, align joined, split back per mate (java:274-405),
- shared-penalty re-allocation across mates (java:207-239),
- overlap double-count fixes: duplicationBonus (java:506-520) and
  overlapMultiplier (java:464-504) with the documented rounding-error guards
  (divideRoundUp/Math.nextUp, java:56-61,100-101),
- best-alignment collection with the tightening MaxErrorRate and the
  Max_PenaltySpan window (java:35-54, 71-92).
"""

from __future__ import annotations

import math

import numpy as np

from mapper_tpu_torch.align.blocks import (
    AlignedBlock,
    QueryAlignment,
    SequenceAlignment,
    block_penalty_in_range,
    new_sequence_alignment,
)
from mapper_tpu_torch.align.candidates import QueryMatch, SequenceMatch
from mapper_tpu_torch.align.dp import AlignmentAnalysis, local_align
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.sequence import Sequence


def divide_round_up(a: float, b: float) -> float:
    """QueryMatch_Aligner.divideRoundUp (java:56-61)."""
    result = a / b
    if result * b < a:
        result = math.nextafter(result, math.inf)
    return result


def next_up(x: float) -> float:
    return math.nextafter(x, math.inf)


class QueryMatchAligner:
    def __init__(self, query: Query, parameters, reference_index=None):
        self.query = query
        self.parameters = parameters
        self.good_alignments: list[QueryAlignment] = []
        self.best_penalty = float(2**31 - 1)
        self.reference_index = reference_index
        # optional per-query memo for _align_match, shareable across aligner
        # instances over the SAME query (batch/engine.py's paired invariance
        # probes re-align the unchanged mate repeatedly); the result is a
        # pure function of the memo key given the query's spacing model
        self.match_memo: dict | None = None

    # --- public API --------------------------------------------------------

    def align(self, match: QueryMatch, extra_spacing: float = 0.0) -> QueryAlignment | None:
        alignment = self._do_align(match, extra_spacing)
        if alignment is not None:
            if alignment.get_penalty() < self.best_penalty:
                self.best_penalty = alignment.get_penalty()
                new_target = alignment.get_penalty() + self.parameters.max_penalty_span
                new_rate = divide_round_up(new_target, self.query.get_length())
                if new_rate < self.parameters.max_error_rate:
                    self.parameters = self.parameters.clone(max_error_rate=new_rate)
            self.good_alignments.append(alignment)
        return alignment

    def get_best_alignments(self) -> list[QueryAlignment]:
        """java:71-92: alignments within Max_PenaltySpan of the best, deduped."""
        max_anywhere = self.query.get_length() * self.parameters.max_error_rate
        cutoff = min(self.best_penalty + self.parameters.max_penalty_span, max_anywhere)
        best = [a for a in self.good_alignments if a.get_penalty() <= cutoff]
        if len(best) <= 1:
            return best
        seen = set()
        unique = []
        for a in best:
            key = a.content_key()
            if key not in seen:
                seen.add(key)
                unique.append(a)
        return unique

    # --- core (doAlign, java:94-272) ---------------------------------------

    def _do_align(self, match: QueryMatch, extra_spacing: float) -> QueryAlignment | None:
        inner_distance = self._get_spacing(match) + extra_spacing
        spacing_penalty = self._compute_spacing_penalty(inner_distance)
        overlap_multiplier = 1.0
        duplication_bonus = 0.0
        max_allowed = next_up(match.get_query_total_length() * self.parameters.max_error_rate)

        if inner_distance > 0:
            min_possible = spacing_penalty + match.priority * self.parameters.mutation_penalty
            if min_possible > max_allowed:
                return None

        result_components: list[SequenceAlignment] | None = None
        components_penalty = 0.0
        if match.get_num_sequences() > 1 and inner_distance < 0:
            joined = self._try_join_query_sequences(match)
            if joined is not None:
                joined_alignment = self._compute_joined_alignment(joined, match)
                result_components = self._split_alignment(joined_alignment, match)
                if result_components is None:
                    return None
                components_penalty = sum(c.get_penalty() for c in result_components)

        if result_components is None:
            result_components = [None] * match.get_num_sequences()
            remaining: list[SequenceMatch | None] = list(match.components)
            num_remaining = match.get_num_sequences()

            if match.hint_forward_order:
                indices = list(range(match.get_num_sequences()))
            else:
                indices = list(range(match.get_num_sequences() - 1, -1, -1))

            if inner_distance < 0 and match.get_num_sequences() > 1:
                # overlapping mates could share all mutations (java:188-203)
                query_total = match.get_query_total_length()
                estimated_overlap = min(
                    -inner_distance,
                    min(
                        len(match.get_component(0).sequence_a),
                        len(match.get_component(1).sequence_a),
                    ),
                )
                estimated_unique = query_total - estimated_overlap
                max_total_component_penalty = (
                    divide_round_up(max_allowed - spacing_penalty, query_total)
                    * estimated_unique
                    * 2
                )
            else:
                max_total_component_penalty = max_allowed - spacing_penalty

            while True:
                num_bases = sum(len(m.sequence_a) for m in remaining if m is not None)
                if num_bases < 1:
                    break
                average_rate = divide_round_up(
                    max_total_component_penalty - components_penalty, num_bases
                )
                sub_params = self.parameters.clone(max_error_rate=average_rate)
                found = False
                for i in indices:
                    component_match = remaining[i]
                    if component_match is None:
                        continue
                    seq_alignment = self._align_match(component_match, sub_params)
                    if seq_alignment is not None:
                        result_components[i] = seq_alignment
                        found = True
                        remaining[i] = None
                        components_penalty += seq_alignment.get_penalty()
                        num_remaining -= 1
                        break
                if num_remaining < 1:
                    break
                if not found:
                    return None

        total_used = components_penalty
        if inner_distance < 0:
            duplication_bonus = self._compute_duplication_bonus(result_components)
            total_used -= duplication_bonus
            multiplied = self._multiply_penalty_for_overlap(result_components, total_used)
            if total_used != 0:
                overlap_multiplier = multiplied / total_used
            else:
                overlap_multiplier = 1.0
            total_used = multiplied
        total_used += spacing_penalty
        if total_used > max_allowed:
            return None
        if len(result_components) > 1:
            # QueryMatch_Aligner.java:261-265 computes this in each
            # component's own sequenceB space; a reverse-strand pair's
            # components live on the RC contig there (reading left-to-right
            # again), which in our forward-folded coordinates is the mirrored
            # difference when component 0 aligned the reverse strand
            if result_components[0].is_reference_reversed():
                actual_inner = (
                    result_components[0].get_start_index_b()
                    - result_components[1].get_end_index_b()
                )
            else:
                actual_inner = (
                    result_components[1].get_start_index_b()
                    - result_components[0].get_end_index_b()
                )
        else:
            actual_inner = 0
        return QueryAlignment(
            result_components,
            spacing_penalty,
            overlap_multiplier,
            duplication_bonus,
            total_used,
            actual_inner,
        )

    # --- paired-overlap join/split (java:274-405) ---------------------------

    def _try_join_query_sequences(self, match: QueryMatch) -> Sequence | None:
        m1, m2 = match.get_component(0), match.get_component(1)
        offset = m2.offset - m1.offset
        if offset >= 0:
            return self._try_join(m1.sequence_a, m2.sequence_a, offset)
        return self._try_join(m2.sequence_a, m1.sequence_a, -offset)

    @staticmethod
    def _try_join(seq1: Sequence, seq2: Sequence, offset: int) -> Sequence | None:
        suffix_start = len(seq1) - offset
        if suffix_start < 0:
            return None
        overlap_end = min(len(seq2), len(seq1) - offset)
        if overlap_end > 0:
            # encoded bytes must be identical across the overlap (java:296-307)
            if not np.array_equal(
                seq1.codes[offset : offset + overlap_end], seq2.codes[:overlap_end]
            ):
                return None
        joined_codes = np.concatenate([seq1.codes, seq2.codes[max(0, suffix_start):]])
        return Sequence("joined", joined_codes)

    def _compute_joined_alignment(
        self, joined: Sequence, match: QueryMatch
    ) -> SequenceAlignment | None:
        joined_offset = min(match.get_component(0).offset, match.get_component(1).offset)
        joined_match = SequenceMatch(joined, match.get_component(0).sequence_b, joined_offset)
        sub_params = self.parameters.clone(
            max_error_rate=next_up(self.parameters.max_error_rate)
        )
        return self._align_match(joined_match, sub_params)

    def _split_alignment(
        self, joined_alignment: SequenceAlignment | None, match: QueryMatch
    ) -> list[SequenceAlignment] | None:
        if joined_alignment is None:
            return None
        m1, m2 = match.get_component(0), match.get_component(1)
        seq1, seq2 = m1.sequence_a, m2.sequence_a
        offset = m2.offset - m1.offset
        if offset >= 0:
            a1 = self._extract(joined_alignment, 0, len(seq1), seq1, m1.reversed)
            a2 = self._extract(joined_alignment, offset, len(seq2) + offset, seq2, m2.reversed)
        else:
            a2 = self._extract(joined_alignment, 0, len(seq2), seq2, m2.reversed)
            a1 = self._extract(
                joined_alignment, -offset, len(seq1) - offset, seq1, m1.reversed
            )
        if a1 is None or a2 is None:
            return None
        return [a1, a2]

    def _extract(
        self,
        joined_alignment: SequenceAlignment,
        query_start: int,
        query_end: int,
        query: Sequence,
        reverse: bool,
    ) -> SequenceAlignment | None:
        """java:362-405."""
        reference_reversed = joined_alignment.is_reference_reversed() != reverse
        reference = joined_alignment.get_sequence_b()
        blocks = []
        for block in joined_alignment.sections:
            if block.start_a >= query_end:
                break
            if block.end_a <= query_start:
                continue
            selection_start = max(block.start_a, query_start)
            selection_end = min(block.end_a, query_end)
            query_selection_length = selection_end - selection_start
            if block.length_a == block.length_b:
                reference_selection_length = query_selection_length
                reference_start = selection_start + block.offset
            elif block.length_a > block.length_b:
                reference_selection_length = 0
                reference_start = block.start_b
            else:
                reference_selection_length = block.length_b
                reference_start = selection_start + block.offset
            blocks.append(
                AlignedBlock(
                    query,
                    reference,
                    selection_start - query_start,
                    reference_start,
                    query_selection_length,
                    reference_selection_length,
                    sequence_b_history=block.sequence_b_history,
                )
            )
        if not blocks:
            return None
        return new_sequence_alignment(blocks, reference_reversed, self.parameters)

    # --- single-sequence window + DP (alignMatch, java:412-462) -------------

    def _align_match(self, sequence_match: SequenceMatch, params) -> SequenceAlignment | None:
        memo = self.match_memo
        if memo is not None:
            # every params clone in this class only changes max_error_rate,
            # so the key below fully determines the result
            key = (
                id(sequence_match.sequence_a),
                id(sequence_match.sequence_b),
                sequence_match.offset,
                sequence_match.from_hashblock_match,
                params.max_error_rate,
            )
            hit = memo.get(key)
            if hit is not None:
                return hit[2]
            result = self._align_match_uncached(sequence_match, params)
            # keep the keyed sequences alive for the memo's lifetime so a
            # temporary (e.g. a joined-mates Sequence) cannot be freed and
            # its id() recycled by a different sequence
            memo[key] = (sequence_match.sequence_a, sequence_match.sequence_b, result)
            return result
        return self._align_match_uncached(sequence_match, params)

    def _align_match_uncached(
        self, sequence_match: SequenceMatch, params
    ) -> SequenceAlignment | None:
        query = sequence_match.sequence_a
        ref = sequence_match.sequence_b
        q_start, q_end = 0, len(query)
        max_interesting = (q_end - q_start) * params.max_error_rate
        max_indel_length = int(
            max(
                0.0,
                (max_interesting - params.deletion_start_penalty)
                / params.deletion_extension_penalty,
            )
        )
        best_offset = sequence_match.offset
        if sequence_match.from_hashblock_match:
            max_shift = max_indel_length
        else:
            max_shift = int(
                max_interesting * self.query.get_spacing_deviation_per_unit_penalty()
            )
            if max_shift < 0:
                return None
            if best_offset + len(query) > len(ref):
                best_offset = len(ref) - len(query)
            if best_offset < 0:
                best_offset = 0

        r_start = max(0, sequence_match.offset - max_shift)
        r_end = min(sequence_match.offset + len(query) + max_shift, len(ref))
        if r_end <= r_start:
            return None

        analysis = AlignmentAnalysis(
            predicted_best_offset=best_offset,
            confident_about_best_offset=sequence_match.from_hashblock_match,
            max_insertion_extension_penalty=max_interesting - params.insertion_start_penalty,
            max_deletion_extension_penalty=max_interesting - params.deletion_start_penalty,
        )
        return local_align(query, ref, q_start, q_end, r_start, r_end, params, analysis)

    # --- paired-end penalty algebra -----------------------------------------

    def _multiply_penalty_for_overlap(
        self, components: list[SequenceAlignment], total_penalty: float
    ) -> float:
        """java:464-504."""
        if len(components) < 2:
            return total_penalty
        first, second = components[0], components[1]
        overlapping = min(first.get_end_index_b(), second.get_end_index_b()) - max(
            first.get_start_index_b(), second.get_start_index_b()
        )
        if overlapping <= 0:
            return total_penalty
        if first.get_start_index_b() <= second.get_start_index_b():
            unique_length_a = (
                first.get_length_a_before(second.get_start_index_b())
                + second.get_length_a()
                + first.get_length_a_after(second.get_end_index_b())
            )
        else:
            unique_length_a = (
                second.get_length_a_before(first.get_start_index_b())
                + first.get_length_a()
                + second.get_length_a_after(first.get_end_index_b())
            )
        deletion = min(first.get_insert_a_or_b_length(), second.get_insert_a_or_b_length())
        unique_length_a -= deletion
        if unique_length_a <= 0:
            return total_penalty
        total_length_a = first.get_length_a() + second.get_length_a()
        return divide_round_up(total_penalty, unique_length_a) * total_length_a

    def _compute_duplication_bonus(self, components: list[SequenceAlignment]) -> float:
        """java:506-520."""
        if len(components) < 2:
            return 0.0
        a, b = components[0], components[1]
        overlapping = min(a.get_end_index_b(), b.get_end_index_b()) - max(
            a.get_start_index_b(), b.get_start_index_b()
        )
        if overlapping < 0:
            return 0.0
        duplicated = (
            self._penalty_in_range(a, b.get_start_index_b(), b.get_end_index_b())
            + self._penalty_in_range(b, a.get_start_index_b(), a.get_end_index_b())
        ) / 2
        return duplicated

    def _penalty_in_range(self, alignment: SequenceAlignment, start_b: int, end_b: int) -> float:
        return sum(
            block_penalty_in_range(block, self.parameters, start_b, end_b)
            for block in alignment.sections
        )

    def _get_spacing(self, match: QueryMatch) -> int:
        if match.get_num_sequences() < 2:
            return 0
        return match.get_total_distance_between_components()

    def _compute_spacing_penalty(self, inner_distance: float) -> float:
        """java:530-546."""
        expected = self.query.get_expected_inner_distance()
        total_length = self.query.get_length()
        if inner_distance < 0 and inner_distance > -1 * total_length:
            return 0.0
        deviation = self.query.get_spacing_deviation_per_unit_penalty()
        return float(int(abs(inner_distance - expected) / deviation))
