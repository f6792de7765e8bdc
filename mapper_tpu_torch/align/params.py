"""The alignment penalty model.

Mirrors the reference's AlignmentParameters (AlignmentParameters.java:6-47) and
the CLI defaulting rules (Mapper.java:409-453):

    MutationPenalty          default 1     (--snp-penalty)
    Insertion/DeletionStart  default 1.5   (--new-indel-penalty)
    DeletionExtension        default 0.5   (--extend-indel-penalty)
    InsertionExtension       = DeletionExtension + additional (default ambiguity)
    MaxErrorRate             default 0.1   (--max-penalty)
    AmbiguityPenalty         default MaxErrorRate (--ambiguity-penalty)
    UnalignedPenalty         = AmbiguityPenalty
    Max_PenaltySpan          default MutationPenalty/2 (--max-penalty-span)

Per-base penalty (AlignmentParameters.java:156-180):
    mismatch                -> MutationPenalty
    compatible w/ ambiguity -> AmbiguityPenalty * falseNegativeRate(union(a,b))
Indel block (110-127): start + extension * length.
"""

from __future__ import annotations

import copy

from dataclasses import dataclass

import numpy as np

from mapper_tpu_torch import basepairs


@dataclass
class AlignmentParameters:
    mutation_penalty: float = 1.0
    insertion_start_penalty: float = 1.5
    insertion_extension_penalty: float = 0.6
    deletion_start_penalty: float = 1.5
    deletion_extension_penalty: float = 0.5
    max_error_rate: float = 0.1
    unaligned_penalty: float = 0.1
    ambiguity_penalty: float = 0.1
    max_num_matches: int = np.iinfo(np.int64).max
    max_penalty_span: float = 0.5
    starting_insertion_start_free: bool = False

    @staticmethod
    def defaults(
        mutation_penalty: float = 1.0,
        indel_start_penalty: float = 1.5,
        indel_extension_penalty: float = 0.5,
        additional_insertion_extension_penalty: float | None = None,
        max_error_rate: float = 0.1,
        ambiguity_penalty: float | None = None,
        max_num_matches: int | None = None,
        max_penalty_span: float | None = None,
    ) -> "AlignmentParameters":
        """Apply the CLI defaulting rules of Mapper.java:409-453."""
        if ambiguity_penalty is None:
            ambiguity_penalty = max_error_rate
        if additional_insertion_extension_penalty is None:
            additional_insertion_extension_penalty = ambiguity_penalty
        if max_penalty_span is None:
            max_penalty_span = mutation_penalty / 2
        return AlignmentParameters(
            mutation_penalty=mutation_penalty,
            insertion_start_penalty=indel_start_penalty,
            insertion_extension_penalty=indel_extension_penalty
            + additional_insertion_extension_penalty,
            deletion_start_penalty=indel_start_penalty,
            deletion_extension_penalty=indel_extension_penalty,
            max_error_rate=max_error_rate,
            unaligned_penalty=ambiguity_penalty,
            ambiguity_penalty=ambiguity_penalty,
            max_num_matches=(
                max_num_matches if max_num_matches is not None else np.iinfo(np.int64).max
            ),
            max_penalty_span=max_penalty_span,
        )

    def clone(self, **overrides) -> "AlignmentParameters":
        # shallow copy keeps the cached penalty table / native params block
        # (they do not depend on max_error_rate, the only hot override);
        # any other override drops them so they rebuild correctly
        new = copy.copy(self)
        for k, v in overrides.items():
            setattr(new, k, v)
        if any(k != "max_error_rate" for k in overrides):
            new.__dict__.pop("_penalty_table", None)
            new.__dict__.pop("_native_params", None)
            new.__dict__.pop("_native_params_ptr", None)
        return new

    def get_starting_insertion_start_penalty(self) -> float:
        return 0.0 if self.starting_insertion_start_free else self.insertion_start_penalty

    def get_min_possible_nonzero_penalty(self) -> float:
        """AlignmentParameters.getMinPossibleNonzeroPenalty (java:42-47)."""
        result = self.mutation_penalty
        result = min(
            result,
            self.get_starting_insertion_start_penalty() + self.insertion_start_penalty,
        )
        result = min(result, self.deletion_start_penalty + self.deletion_extension_penalty)
        return result

    # --- per-base penalties ---------------------------------------------

    def base_penalty(self, query_code, ref_code):
        """Vectorized per-base penalty (AlignmentParameters.java:156-180):
        a cached 16x16 float64 table gather (the formula evaluated per call
        was a hot path in block-penalty sums; the table holds bit-identical
        values)."""
        table = self.__dict__.get("_penalty_table")
        if table is None:
            codes = np.arange(16, dtype=np.uint8)
            q, w = codes[:, None], codes[None, :]
            matches = basepairs.can_match(q, w)
            ambiguity = self.ambiguity_penalty * basepairs.mutation_false_negative_rate(
                basepairs.union(q, w)
            )
            table = np.where(matches, ambiguity, self.mutation_penalty)
            self.__dict__["_penalty_table"] = table
        return table[
            np.asarray(query_code, dtype=np.uint8),
            np.asarray(ref_code, dtype=np.uint8),
        ]

    def substitution_table(self) -> np.ndarray:
        """A 16x16 float32 table of per-base penalties, device-kernel-ready."""
        codes = np.arange(16, dtype=np.uint8)
        return self.base_penalty(codes[:, None], codes[None, :]).astype(np.float32)
