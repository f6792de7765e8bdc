"""Alignment result model: AlignedBlock / SequenceAlignment / QueryAlignment /
QueryAlignments.

Mirrors the reference's QuickVariants classes of the same names (APIs
reconstructed in SURVEY.md §2.3 from their usage throughout mapper code):

- AlignedBlock: a gapless 1-1 run (lenA == lenB), an insertion (lenB == 0), or
  a deletion (lenA == 0) with absolute coordinates into both sequences.
- SequenceAlignment: an ordered list of AlignedBlocks for one query sequence
  plus penalty accounting: query bases outside the blocks are "unaligned tails"
  charged UnalignedPenalty each (AlignmentParameters.newSequenceAlignment,
  AlignmentParameters.java:73-95).
- QueryAlignment: one alignment choice for the whole (possibly paired) query,
  with the paired-end penalty algebra fields (spacing penalty, overlap
  multiplier, duplication bonus).
- QueryAlignments: per-component lists of alignment choices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.sequence import Sequence


@dataclass(frozen=True, slots=True)
class AlignedBlock:
    sequence_a: Sequence
    sequence_b: Sequence
    start_a: int
    start_b: int
    length_a: int
    length_b: int
    # For ancestry inference, penalties are computed against the ancestral
    # ("history") version of sequence B while coordinates/output use the
    # original (AlignedBlock.getSequenceBHistory via AlignmentParameters.java:112)
    sequence_b_history: Sequence | None = None

    @property
    def end_a(self) -> int:
        return self.start_a + self.length_a

    @property
    def end_b(self) -> int:
        return self.start_b + self.length_b

    @property
    def offset(self) -> int:
        return self.start_b - self.start_a

    def get_sequence_b_history(self) -> Sequence:
        return self.sequence_b_history if self.sequence_b_history is not None else self.sequence_b

    @property
    def is_indel(self) -> bool:
        return self.length_a != self.length_b

    @property
    def indel_length(self) -> int:
        return abs(self.length_a - self.length_b)

    def same_indel_type(self, other: "AlignedBlock") -> bool:
        return (self.length_a > self.length_b) == (other.length_a > other.length_b)


def block_penalty(block: AlignedBlock, params) -> float:
    """AlignmentParameters.getPenalty(AlignedBlock) (java:106-126)."""
    if block.length_a == block.length_b:
        a = block.sequence_a.codes[block.start_a : block.end_a]
        b = block.get_sequence_b_history().codes[block.start_b : block.end_b]
        return float(np.sum(params.base_penalty(a, b)))
    if block.length_a > 0:
        return params.insertion_start_penalty + params.insertion_extension_penalty * block.length_a
    return params.deletion_start_penalty + params.deletion_extension_penalty * block.length_b


def block_penalty_in_range(block: AlignedBlock, params, start_b: int, end_b: int) -> float:
    """AlignmentParameters.getPenalty(block, startIndexB, endIndexB)
    (java:128-154): only count contributions inside [start_b, end_b) of B."""
    if block.length_a == block.length_b:
        lo = max(block.start_b, start_b)
        hi = min(block.end_b, end_b)
        if lo >= hi:
            return 0.0
        a = block.sequence_a.codes[block.start_a + (lo - block.start_b) : block.start_a + (hi - block.start_b)]
        b = block.get_sequence_b_history().codes[lo:hi]
        return float(np.sum(params.base_penalty(a, b)))
    if block.start_b < end_b and block.end_b > start_b:
        if block.length_a > 0:
            return params.insertion_start_penalty + params.insertion_extension_penalty * block.length_a
        return params.deletion_start_penalty + params.deletion_extension_penalty * block.length_b
    return 0.0


class SequenceAlignment:
    __slots__ = ("sections", "reference_reversed", "total_penalty", "aligned_penalty")

    def __init__(
        self,
        sections: list[AlignedBlock],
        reference_reversed: bool,
        total_penalty: float,
        aligned_penalty: float,
    ):
        self.sections = sections
        self.reference_reversed = reference_reversed
        self.total_penalty = total_penalty
        self.aligned_penalty = aligned_penalty

    # --- accessors mirroring the reference -------------------------------

    def get_penalty(self) -> float:
        return self.total_penalty

    def get_aligned_penalty(self) -> float:
        return self.aligned_penalty

    def get_sequence_a(self) -> Sequence:
        return self.sections[0].sequence_a

    def get_sequence_b(self) -> Sequence:
        return self.sections[0].sequence_b

    def get_start_index_b(self) -> int:
        return self.sections[0].start_b

    def get_end_index_b(self) -> int:
        return self.sections[-1].end_b

    def get_start_offset(self) -> int:
        first = self.sections[0]
        return first.start_b - first.start_a

    def get_length_a(self) -> int:
        return sum(s.length_a for s in self.sections)

    def get_length_a_before(self, index_b: int) -> int:
        """Query length aligned before reference position index_b."""
        total = 0
        for s in self.sections:
            if s.end_b <= index_b:
                total += s.length_a
            elif s.start_b < index_b and s.length_a == s.length_b:
                total += index_b - s.start_b
        return total

    def get_length_a_after(self, index_b: int) -> int:
        total = 0
        for s in self.sections:
            if s.start_b >= index_b:
                total += s.length_a
            elif s.end_b > index_b and s.length_a == s.length_b:
                total += s.end_b - index_b
        return total

    def get_insert_a_or_b_length(self) -> int:
        return sum(s.indel_length for s in self.sections if s.is_indel)

    def count_num_indels(self) -> int:
        return sum(1 for s in self.sections if s.is_indel)

    def is_reference_reversed(self) -> bool:
        return self.reference_reversed

    def has_ambiguous_basepairs(self) -> bool:
        for s in self.sections:
            if s.length_a and np.any(
                basepairs.is_ambiguous(s.sequence_a.codes[s.start_a : s.end_a])
            ):
                return True
            if s.length_b and np.any(
                basepairs.is_ambiguous(s.sequence_b.codes[s.start_b : s.end_b])
            ):
                return True
        return False

    # --- text rendering ---------------------------------------------------

    def get_aligned_text_a(self) -> str:
        parts = []
        for s in self.sections:
            parts.append(s.sequence_a.get_range(s.start_a, s.length_a))
            if s.length_b > s.length_a:
                parts.append("-" * (s.length_b - s.length_a))
        return "".join(parts)

    def get_aligned_text_b(self) -> str:
        parts = []
        for s in self.sections:
            parts.append(s.sequence_b.get_range(s.start_b, s.length_b))
            if s.length_a > s.length_b:
                parts.append("-" * (s.length_a - s.length_b))
        return "".join(parts)

    def format(self) -> str:
        return self.get_aligned_text_a() + "\n" + self.get_aligned_text_b()

    def cigar(self) -> str:
        """CIGAR string, with soft clips for unaligned query tails."""
        parts = []
        query_len = len(self.get_sequence_a())
        leading = self.sections[0].start_a
        trailing = query_len - self.sections[-1].end_a
        if leading:
            parts.append(f"{leading}S")
        for s in self.sections:
            if s.length_a == s.length_b:
                parts.append(f"{s.length_a}M")
            elif s.length_a > 0:
                parts.append(f"{s.length_a}I")
            else:
                parts.append(f"{s.length_b}D")
        if trailing:
            parts.append(f"{trailing}S")
        return "".join(parts)

    def content_key(self):
        return (
            id(self.sections[0].sequence_b),
            self.reference_reversed,
            tuple((s.start_a, s.start_b, s.length_a, s.length_b) for s in self.sections),
        )

    def with_sequence_b(self, new_b: Sequence) -> "SequenceAlignment":
        """Rewrite sequence B keeping the history for penalties
        (QueryAlignment.putSequenceB ancestral->original rewrite,
        AlignerWorker.java:689-693)."""
        new_sections = [
            AlignedBlock(
                s.sequence_a,
                new_b,
                s.start_a,
                s.start_b,
                s.length_a,
                s.length_b,
                sequence_b_history=s.get_sequence_b_history(),
            )
            for s in self.sections
        ]
        return SequenceAlignment(
            new_sections, self.reference_reversed, self.total_penalty, self.aligned_penalty
        )

    def with_sequence_a(self, new_a: Sequence) -> "SequenceAlignment":
        new_sections = [
            AlignedBlock(
                new_a,
                s.sequence_b,
                s.start_a,
                s.start_b,
                s.length_a,
                s.length_b,
                sequence_b_history=s.sequence_b_history,
            )
            for s in self.sections
        ]
        return SequenceAlignment(
            new_sections, self.reference_reversed, self.total_penalty, self.aligned_penalty
        )


def new_sequence_alignment(
    sections: list[AlignedBlock], reference_reversed: bool, params
) -> SequenceAlignment:
    """AlignmentParameters.newSequenceAlignment (java:73-95): sum block
    penalties, refund a leading free insertion, then charge unaligned tails."""
    aligned_query_length = 0
    total = 0.0
    for block in sections:
        total += block_penalty(block, params)
        aligned_query_length += block.length_a
    if sections:
        first = sections[0]
        if params.starting_insertion_start_free and first.length_b == 0:
            total -= params.insertion_start_penalty
    aligned_penalty = total
    if sections:
        unaligned = len(sections[0].sequence_a) - aligned_query_length
        total += unaligned * params.unaligned_penalty
    return SequenceAlignment(sections, reference_reversed, total, aligned_penalty)


class QueryAlignment:
    """One alignment choice for a whole query (1 component, or 2 for
    paired-end)."""

    __slots__ = (
        "components",
        "spacing_penalty",
        "overlap_multiplier",
        "duplication_bonus",
        "total_penalty",
        "inner_distance",
    )

    def __init__(
        self,
        components: list[SequenceAlignment] | SequenceAlignment,
        spacing_penalty: float = 0.0,
        overlap_multiplier: float = 1.0,
        duplication_bonus: float = 0.0,
        total_penalty: float | None = None,
        inner_distance: int = 0,
    ):
        if isinstance(components, SequenceAlignment):
            components = [components]
        self.components = components
        self.spacing_penalty = spacing_penalty
        self.overlap_multiplier = overlap_multiplier
        self.duplication_bonus = duplication_bonus
        if total_penalty is None:
            total_penalty = sum(c.get_penalty() for c in components) + spacing_penalty
        self.total_penalty = total_penalty
        self.inner_distance = inner_distance

    def get_penalty(self) -> float:
        return self.total_penalty

    def get_components(self) -> list[SequenceAlignment]:
        return self.components

    def get_component(self, i: int) -> SequenceAlignment:
        return self.components[i]

    def get_num_sequences(self) -> int:
        return len(self.components)

    def get_sequence_b(self) -> Sequence:
        return self.components[0].get_sequence_b()

    def put_sequence_b(self, new_b: Sequence) -> None:
        self.components = [c.with_sequence_b(new_b) for c in self.components]

    def with_query(self, sequences: list[Sequence]) -> "QueryAlignment":
        # each component keeps its strand: one aligned as the read's reverse
        # complement gets the new read's reverse complement
        new_components = [
            c.with_sequence_a(
                sequences[i].reverse_complement()
                if c.get_sequence_a().complemented_from is not None
                else sequences[i]
            )
            for i, c in enumerate(self.components)
        ]
        return QueryAlignment(
            new_components,
            self.spacing_penalty,
            self.overlap_multiplier,
            self.duplication_bonus,
            self.total_penalty,
            self.inner_distance,
        )

    def has_indel(self) -> bool:
        return any(c.count_num_indels() > 0 for c in self.components)

    def has_ambiguous_basepairs(self) -> bool:
        return any(c.has_ambiguous_basepairs() for c in self.components)

    def content_key(self):
        return tuple(c.content_key() for c in self.components)

    def __eq__(self, other) -> bool:
        return isinstance(other, QueryAlignment) and self.content_key() == other.content_key()

    def __hash__(self) -> int:
        return hash(self.content_key())

    def format(self) -> str:
        return "\n".join(c.format() for c in self.components)

    def explain_penalty(self) -> str:
        parts = [f"components={sum(c.get_penalty() for c in self.components)}"]
        if self.spacing_penalty:
            parts.append(f"spacing={self.spacing_penalty}")
        if self.duplication_bonus:
            parts.append(f"duplicationBonus=-{self.duplication_bonus}")
        if self.overlap_multiplier != 1.0:
            parts.append(f"overlapMultiplier={self.overlap_multiplier}")
        parts.append(f"total={self.total_penalty}")
        return " ".join(parts)


class QueryAlignments:
    """Per-component alignment choices for one query (QueryAlignments in the
    reference; statics singleChoice/singleComponent/unaligned per
    AlignerWorker.java:351,471,480)."""

    # device_counted: set by the batch engine when this result's depth was
    # already scatter-added on the device (batch/device_pileup.py) — the host
    # MatchDatabase then skips it.  via_exact: resolved by the exact per-pair
    # machinery rather than the batch fast path (stats only).
    __slots__ = (
        "query_sequences",
        "alignments_per_component",
        "device_counted",
        "via_exact",
    )

    def __init__(self, query_sequences: list[Sequence], alignments_per_component: list[list[QueryAlignment]]):
        self.query_sequences = query_sequences
        self.alignments_per_component = alignments_per_component
        # set, so that reading it costs no AttributeError
        self.device_counted = False

    @staticmethod
    def single_choice(alignment: QueryAlignment) -> "QueryAlignments":
        sequences = [c.get_sequence_a() for c in alignment.components]
        return QueryAlignments(sequences, [[alignment]])

    @staticmethod
    def single_component(
        query_sequences: list[Sequence], alignments: list[QueryAlignment]
    ) -> "QueryAlignments":
        return QueryAlignments(query_sequences, [alignments])

    @staticmethod
    def unaligned(query_sequences: list[Sequence]) -> "QueryAlignments":
        return QueryAlignments(query_sequences, [[]])

    def get_num_components(self) -> int:
        return len(self.alignments_per_component)

    def get_alignments(self, i: int | None = None):
        if i is None:
            return self.alignments_per_component
        return self.alignments_per_component[i]

    def get_first_alignments(self) -> list[QueryAlignment]:
        return self.alignments_per_component[0]

    def get_query_length(self, i: int) -> int:
        if self.get_num_components() == 1:
            return sum(len(s) for s in self.query_sequences)
        return len(self.query_sequences[i])

    def get_total_of_all_components(self) -> int:
        return sum(len(a) for a in self.alignments_per_component)


class LazyUngappedAlignments(QueryAlignments):
    """Single-component QueryAlignments whose QueryAlignment objects are
    materialized on first access.

    The batch engine's clean-ungapped majority emission
    (engine._finish_single_end) carries only columnar row data — one
    (reversed, contig index, offset, penalty) tuple per choice — and
    listeners with columnar fast paths (SamWriter, MatchDatabase's
    difference-array pileup) consume the rows directly, so the per-alignment
    object tree (AlignedBlock/SequenceAlignment/QueryAlignment) is never
    built on the hot path at all.  Any consumer that calls the regular
    accessors gets the identical objects, built once on demand
    (tests/test_lazy_emission.py pins equality with the eager path)."""

    __slots__ = ("rows", "_materialize")

    def __init__(self, query_sequences, rows, materialize):
        self.query_sequences = query_sequences
        self.alignments_per_component = None
        self.device_counted = False
        # rows: list of (reversed, ref_seq_index, offset, penalty)
        self.rows = rows
        self._materialize = materialize

    def _ensure(self) -> None:
        if self.alignments_per_component is None:
            self.alignments_per_component = [self._materialize(self)]

    def get_num_components(self) -> int:
        return 1

    def get_alignments(self, i: int | None = None):
        self._ensure()
        if i is None:
            return self.alignments_per_component
        return self.alignments_per_component[i]

    def get_first_alignments(self) -> list[QueryAlignment]:
        self._ensure()
        return self.alignments_per_component[0]

    def get_query_length(self, i: int) -> int:
        return sum(len(s) for s in self.query_sequences)

    def get_total_of_all_components(self) -> int:
        return len(self.rows)
