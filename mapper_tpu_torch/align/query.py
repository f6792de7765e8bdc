"""Query model (reference: QuickVariants Query + mapper QueryBuilder).

A Query is 1-2 sequences (paired-end mates) plus the spacing model
(expectedInnerDistance, spacingDeviationPerUnitPenalty); see
AlignerWorker_Test.java:84,160 and QueryBuilder.java:20-30.
"""

from __future__ import annotations

from mapper_tpu_torch.sequence import Sequence, SequenceBuilder


class Query:
    def __init__(
        self,
        sequences: Sequence | list[Sequence],
        sequence2: Sequence | None = None,
        expected_inner_distance: float = 0.0,
        spacing_deviation_per_unit_penalty: float = 1.0,
    ):
        if isinstance(sequences, Sequence):
            sequences = [sequences]
        else:
            sequences = list(sequences)
        if sequence2 is not None:
            sequences.append(sequence2)
        self.sequences = sequences
        self.expected_inner_distance = expected_inner_distance
        self.spacing_deviation_per_unit_penalty = spacing_deviation_per_unit_penalty
        self.identifier = sequences[0].identifier

    def get_num_sequences(self) -> int:
        return len(self.sequences)

    def get_sequence(self, i: int) -> Sequence:
        return self.sequences[i]

    def get_sequences(self) -> list[Sequence]:
        return self.sequences

    def get_length(self) -> int:
        return sum(len(s) for s in self.sequences)

    def get_expected_inner_distance(self) -> float:
        return self.expected_inner_distance

    def get_spacing_deviation_per_unit_penalty(self) -> float:
        return self.spacing_deviation_per_unit_penalty

    def get_id(self) -> int:
        return self.identifier

    def subquery(self, i: int) -> "Query":
        # keeps the spacing model so the contig-edge rescue's spacing penalty is
        # computed against the parent query's expectations
        return Query(
            self.sequences[i],
            expected_inner_distance=self.expected_inner_distance,
            spacing_deviation_per_unit_penalty=self.spacing_deviation_per_unit_penalty,
        )

    def format(self) -> str:
        return ", ".join(s.get_text() for s in self.sequences)

    def content_hash(self) -> int:
        """Content hash for the alignment result cache (the reference uses
        Query.hashCode; AlignerWorker.java:283)."""
        return hash(
            (
                tuple(s.codes.tobytes() for s in self.sequences),
                self.expected_inner_distance,
                self.spacing_deviation_per_unit_penalty,
            )
        )


class QueryBuilder:
    """Carries the spacing model from the provider into the Query
    (QueryBuilder.java:20-30)."""

    def __init__(
        self,
        builders: list[SequenceBuilder],
        expected_inner_distance: float = 0.0,
        spacing_deviation_per_unit_penalty: float = 1.0,
    ):
        self.builders = builders
        self.expected_inner_distance = expected_inner_distance
        self.spacing_deviation_per_unit_penalty = spacing_deviation_per_unit_penalty
        self.identifier = -1

    def set_id(self, identifier: int) -> None:
        self.identifier = identifier

    def get_length(self) -> int:
        return sum(b.get_length() for b in self.builders)

    def build(self) -> Query:
        sequences = []
        for b in self.builders:
            b.set_id(self.identifier)
            sequences.append(b.build())
        return Query(
            sequences,
            expected_inner_distance=self.expected_inner_distance,
            spacing_deviation_per_unit_penalty=self.spacing_deviation_per_unit_penalty,
        )
