"""Embeddable API (reference: Api.java:15-109).

    index = Api.new_database(["ref.fasta"]) or Api.new_database({"ref": "ACGT..."})
    alignments = Api.align(query_sequence, index, params)

The reference's Api builds SequenceDatabase -> HashBlock_Database ->
DuplicationDetector(minCopies=2, window=1) (Api.java:41-70) and aligns with a
synchronous throw-away worker (Api.java:79-92). We mirror that structure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence as TypingSequence

from mapper_tpu_torch.align.params import AlignmentParameters
from mapper_tpu_torch.sequence import Sequence, SequenceDatabase, sort_and_complement


@dataclass
class ReferenceIndex:
    """Bundles the sequence database with its hashblock index and duplication
    info (reference: ReferenceDatabase.java:8-16)."""

    sequence_database: SequenceDatabase
    hashblock_database: object  # mapper_tpu_torch.index.database.HashBlockDatabase
    duplication_detector: object | None = None

    def get_original_sequence(self, sequence: Sequence) -> Sequence:
        """Maps an (ancestral) alignment target back to the original contig
        (ReferenceProvider.getOriginalSequence)."""
        return self.hashblock_database.get_original_sequence(sequence)


class Api:
    @staticmethod
    def new_database(
        reference,
        cache_dir: str | None = None,
        enable_gapmers: bool = True,
    ) -> ReferenceIndex:
        """Build a reference index.

        `reference` may be a path, a list of paths, or a mapping of
        {contig name: sequence text} (Api.java:35-70).
        """
        from mapper_tpu_torch.index.database import HashBlockDatabase
        from mapper_tpu_torch.index.duplication import DuplicationDetector
        from mapper_tpu_torch.io import fastx

        sequences: list[Sequence] = []
        if isinstance(reference, Mapping):
            for name, text in reference.items():
                sequences.append(Sequence.from_text(name, text))
        else:
            paths = [reference] if isinstance(reference, str) else list(reference)
            provider = fastx.load_from(paths, keep_quality=False)
            for builder in provider:
                sequences.append(builder.build())

        sorted_seqs = sort_and_complement(sequences)
        seq_db = SequenceDatabase(sorted_seqs)
        hb_db = HashBlockDatabase(seq_db, enable_gapmers=enable_gapmers, cache_dir=cache_dir)
        dup = DuplicationDetector(hb_db, min_num_interesting_copies=2, window_size=1)
        return ReferenceIndex(seq_db, hb_db, dup)

    @staticmethod
    def align(query, index: ReferenceIndex, parameters: AlignmentParameters | None = None):
        """Align one query (a Sequence, a text, or a Query) against the index.

        Returns a QueryAlignments (reference: Api.align, Api.java:79-92).
        """
        from mapper_tpu_torch.align.query import Query
        from mapper_tpu_torch.align.worker import AlignerWorker

        if parameters is None:
            parameters = AlignmentParameters.defaults()
        if isinstance(query, str):
            query = Query(Sequence.from_text("query", query))
        elif isinstance(query, Sequence):
            query = Query(query)
        worker = AlignerWorker(index, parameters)
        return worker.align(query)

    @staticmethod
    def align_once(reference, query, parameters: AlignmentParameters | None = None):
        """Convenience: build a database and align one query (Api.java:96-107)."""
        index = Api.new_database(reference)
        return Api.align(query, index, parameters)
