"""Reads-per-reference-combination summary (reference: QuickVariants
ReferenceAlignmentCounter; --out-refs-map-count, Mapper.java:701-756).

Counts, for every combination of reference sources a query aligned to, the
number of queries with that combination.  A query aligning to several contigs
of the same reference file counts toward that file once; queries matching
contigs from multiple --reference files count toward the combined row.
"""

from __future__ import annotations

from mapper_tpu_torch.align.blocks import QueryAlignments


class ReferenceAlignmentCounter:
    def __init__(self):
        self.counts: dict[tuple[str, ...], int] = {}

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        for query_alignments in results:
            # columnar fast path: lazy emission rows carry the ref Sequence
            rows = getattr(query_alignments, "rows", None)
            if rows is not None and query_alignments.alignments_per_component is None:
                if rows:
                    srcs = {
                        r[1].path if r[1].path is not None else r[1].name
                        for r in rows
                    }
                    key = tuple(sorted(srcs))
                    self.counts[key] = self.counts.get(key, 0) + 1
                continue
            sources: set[str] = set()
            for component in query_alignments.get_alignments():
                for choice in component:
                    for seq_alignment in choice.get_components():
                        ref = seq_alignment.get_sequence_b()
                        source = ref.path if ref.path is not None else ref.name
                        sources.add(source)
            if sources:
                key = tuple(sorted(sources))
                self.counts[key] = self.counts.get(key, 0) + 1

    def sum_alignments(self, out_path: str) -> None:
        with open(out_path, "wt", encoding="ascii") as handle:
            handle.write("# reads mapped per combination of references\n")
            handle.write("COUNT\tREFERENCES\n")
            for key in sorted(self.counts, key=lambda k: (-self.counts[k], k)):
                handle.write(f"{self.counts[key]}\t{','.join(key)}\n")


class UnalignedQueryWriter:
    """Writes reads with no alignments (reference: UnalignedQuery_Writer;
    fasta/fastq chosen by extension, Mapper.java:727-731, README.md:95)."""

    def __init__(self, path: str, all_reads_have_quality: bool, stream=None):
        from mapper_tpu_torch.io import fastx

        self.path = path
        # the records go to `stream` when one is given (one process's share
        # of a multi-process run), in the format `path` names
        target = path if stream is None else stream
        base = path[:-3] if path.endswith(".gz") else path
        if base.endswith((".fastq", ".fq")):
            self.writer = fastx.FastqWriter(target)
        elif base.endswith((".fasta", ".fa", ".fna")):
            self.writer = fastx.FastaWriter(target)
        else:
            raise ValueError(
                f"--out-unaligned path {path!r} must have a .fasta or .fastq extension"
            )

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        for query_alignments in results:
            components = query_alignments.get_alignments()
            if all(len(options) == 0 for options in components):
                for sequence in query_alignments.query_sequences:
                    self.writer.write(sequence)

    def close(self) -> None:
        self.writer.close()
