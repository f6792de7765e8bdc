"""SAM output (reference: QuickVariants SamWriter; format pinned by
SamWriter_Test.java:26-93).

Observed row format:
    QNAME  FLAG  RNAME  POS(1-based)  255  CIGAR  RNEXT  PNEXT  TLEN  SEQ  *
    [cs:f:<spacingPenalty>]  AS:f:<penalty>
- TLEN is the component's query length (SamWriter_Test: 5 / 10);
- paired flags observed: 99/147 proper pair, 73 mate-unmapped-first; the
  reverse-strand bits follow the SAM spec;
- multiple alignment choices produce multiple rows with no secondary flag;
- RNEXT names the mate contig explicitly (not '=').
"""

from __future__ import annotations

import numpy as np

from mapper_tpu_torch.align.blocks import QueryAlignment, QueryAlignments
from mapper_tpu_torch.sequence import Sequence

FLAG_PAIRED = 1
FLAG_PROPER_PAIR = 2
FLAG_UNMAPPED = 4
FLAG_MATE_UNMAPPED = 8
FLAG_REVERSE = 16
FLAG_MATE_REVERSE = 32
FLAG_FIRST = 64
FLAG_SECOND = 128


def java_float_str(x: float) -> str:
    """Shortest decimal that round-trips to float32 (Java Float.toString)."""
    value = np.float32(x)
    if np.isnan(value):
        return "NaN"
    text = np.format_float_positional(value, unique=True, trim="0")
    if text.endswith("."):
        text += "0"
    if text.startswith("."):
        text = "0" + text
    if text.startswith("-."):
        text = "-0" + text[1:]
    return text


def _query_name(sequence: Sequence) -> str:
    if sequence.complemented_from is not None:
        return sequence.complemented_from.name
    return sequence.name


class SamWriter:
    """AlignmentListener emitting SAM rows."""

    def __init__(self, sequence_database, stream, contains_paired_end: bool):
        self.stream = stream
        self.contains_paired_end = contains_paired_end
        self._write_header(sequence_database)

    def _write_header(self, sequence_database) -> None:
        self.stream.write("@HD\tVN:1.6\tSO:unsorted\n")
        for seq in sequence_database.get_forward_sequences_only():
            self.stream.write(f"@SQ\tSN:{seq.name}\tLN:{len(seq)}\n")

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        for query_alignments in results:
            rows = getattr(query_alignments, "rows", None)
            if rows is not None and query_alignments.alignments_per_component is None:
                self._write_lazy_rows(query_alignments, rows)
            else:
                self._write_query(query_alignments)

    def _write_lazy_rows(self, query_alignments, rows) -> None:
        """Columnar fast path for the batch engine's LazyUngappedAlignments
        (full-length single-block ungapped choices): emits byte-identical
        rows to _write_query without materializing the alignment objects."""
        seq = query_alignments.query_sequences[0]
        tlen = str(len(seq))
        cigar = f"{len(seq)}M"
        write = self.stream.write
        for rev, ref, off, pen in rows:
            seq_a = seq.reverse_complement() if rev else seq
            write(
                "\t".join(
                    (
                        _query_name(seq_a),
                        "16" if seq_a.complemented_from is not None else "0",
                        ref.name,
                        str(off + 1),
                        "255",
                        cigar,
                        "*",
                        "0",
                        tlen,
                        seq_a.get_text(),
                        "*",
                        "AS:f:" + java_float_str(pen),
                    )
                )
                + "\n"
            )

    def _write_query(self, query_alignments: QueryAlignments) -> None:
        components = query_alignments.get_alignments()
        if len(components) == 1:
            for choice in components[0]:
                self._write_choice(choice)
        else:
            # components aligned separately (unpaired fallback): each aligned
            # component is emitted with the mate-unmapped flag
            for index, options in enumerate(components):
                for choice in options:
                    self._write_half_mapped(choice, index)

    def _write_choice(self, choice: QueryAlignment) -> None:
        parts = choice.get_components()
        if len(parts) == 1:
            self._write_row(
                parts[0],
                flag=self._strand_flag(parts[0]),
                rnext="*",
                pnext=0,
                spacing=None,
            )
        else:
            first, second = parts[0], parts[1]
            flags = [
                FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_FIRST,
                FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_SECOND,
            ]
            for i, (mine, mate) in enumerate(((first, second), (second, first))):
                flag = flags[i]
                if mine.is_reference_reversed():
                    flag |= FLAG_REVERSE
                if mate.is_reference_reversed():
                    flag |= FLAG_MATE_REVERSE
                self._write_row(
                    mine,
                    flag=flag,
                    rnext=mate.get_sequence_b().name,
                    pnext=mate.get_start_index_b() + 1,
                    spacing=choice.spacing_penalty,
                )

    def _write_half_mapped(self, choice: QueryAlignment, component_index: int) -> None:
        part = choice.get_component(0)
        flag = FLAG_PAIRED | FLAG_MATE_UNMAPPED
        flag |= FLAG_FIRST if component_index == 0 else FLAG_SECOND
        if part.is_reference_reversed():
            flag |= FLAG_REVERSE
        self._write_row(
            part, flag=flag, rnext="*", pnext=0, spacing=choice.spacing_penalty
        )

    @staticmethod
    def _strand_flag(alignment) -> int:
        return FLAG_REVERSE if alignment.is_reference_reversed() else 0

    def _write_row(self, alignment, flag: int, rnext: str, pnext: int, spacing) -> None:
        seq_a = alignment.get_sequence_a()
        fields = [
            _query_name(seq_a),
            str(flag),
            alignment.get_sequence_b().name,
            str(alignment.get_start_index_b() + 1),
            "255",
            alignment.cigar(),
            rnext,
            str(pnext),
            str(len(seq_a)),
            seq_a.get_text(),
            "*",
        ]
        if spacing is not None:
            fields.append("cs:f:" + java_float_str(spacing))
        fields.append("AS:f:" + java_float_str(alignment.get_penalty()))
        self.stream.write("\t".join(fields) + "\n")
