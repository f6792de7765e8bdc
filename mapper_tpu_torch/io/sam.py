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

from mapper_tpu_torch.align.blocks import QueryAlignments
from mapper_tpu_torch.native import samrows as native_samrows
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
    """AlignmentListener emitting SAM rows, a batch's rows in one native
    pass (native/samrows.cpp)."""

    def __init__(self, sequence_database, stream, contains_paired_end: bool):
        self.stream = stream
        self.contains_paired_end = contains_paired_end
        self._formatter = native_samrows.RowFormatter()
        self._write_header(sequence_database)

    def _write_header(self, sequence_database) -> None:
        self.stream.write("@HD\tVN:1.6\tSO:unsorted\n")
        for seq in sequence_database.get_forward_sequences_only():
            self.stream.write(f"@SQ\tSN:{seq.name}\tLN:{len(seq)}\n")

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        text = self._format(results, by_result=False)
        if text:
            self.stream.write(text)

    def texts_by_result(self, results: list[QueryAlignments]) -> list[str]:
        """The rows of each of `results`, one text each, from one native
        pass over the batch (as `multihost.ShardedResultWriter` keeps them)."""
        return self._format(results, by_result=True)

    def _format(self, results: list[QueryAlignments], by_result: bool):
        """The rows of `results` from one native pass (native/samrows.cpp),
        as one text or (`by_result`) one text a result, with no Sequence,
        numpy call or f-string per row: the names, the query sequences'
        codes, the rows' fields and their blocks go in as flat tables, and
        each distinct float32 penalty of the batch is formatted once by
        java_float_str.  A row reads as QuickVariants' SamWriter writes it:
        the flags, RNEXT and PNEXT of a single-end choice, of a proper pair
        and of a mate aligned alone, and the CIGAR of
        SequenceAlignment.cigar()."""
        names: list[str] = []
        name_ids: dict[int, int] = {}  # id(reference sequence) -> name
        entry_ids: dict[int, int] = {}  # id(query sequence) -> entry
        entries: list[int] = []  # (code offset, length, name) each
        code_parts: list[np.ndarray] = []
        records: list[int] = []  # native_samrows.FIELDS a row, in write order
        blocks: list[int] = []  # (start_a, length_a, length_b) each
        penalties: list[float] = []  # a row's AS:f
        spacings: list[float] = []  # the cs:f of the rows that have one
        result_rows: list[int] = []  # the rows written up to each result's end
        num_codes = 0

        def name_of(ref: Sequence) -> int:
            name = name_ids.get(id(ref))
            if name is None:
                name = name_ids[id(ref)] = len(names)
                names.append(ref.name)
            return name

        def entry_of(seq: Sequence) -> int:
            nonlocal num_codes
            entry = entry_ids.get(id(seq))
            if entry is None:
                entry = entry_ids[id(seq)] = len(entries) // 3
                codes = seq.codes
                entries.extend((num_codes, len(codes), len(names)))
                names.append(_query_name(seq))
                code_parts.append(codes)
                num_codes += len(codes)
            return entry

        def add_row(alignment, flag: int, mate, spacing) -> None:
            sections = alignment.sections
            first = sections[0]
            if mate is None:
                mate_name, mate_start = -1, 0
            else:
                mate_first = mate.sections[0]
                mate_name, mate_start = name_of(mate_first.sequence_b), mate_first.start_b
            if spacing is None:
                spacing_index = -1
            else:
                spacing_index = len(spacings)
                spacings.append(spacing)
            records.extend((entry_of(first.sequence_a), 0, flag, name_of(first.sequence_b), first.start_b,
                            mate_name, mate_start, len(sections), spacing_index))
            for block in sections:
                blocks.extend((block.start_a, block.length_a, block.length_b))
            penalties.append(alignment.total_penalty)

        pair_flags = (FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_FIRST, FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_SECOND)
        half_flags = (FLAG_PAIRED | FLAG_MATE_UNMAPPED | FLAG_FIRST, FLAG_PAIRED | FLAG_MATE_UNMAPPED | FLAG_SECOND)
        last_ref, last_name = None, -1
        for query_alignments in results:
            rows = getattr(query_alignments, "rows", None)
            if rows is not None and query_alignments.alignments_per_component is None:
                # the engine's lazy ungapped rows: the read's codes,
                # reverse-complemented natively where the row is reversed; a
                # read given as a reverse complement reads as reversed where
                # the row is not (the reverse complement of its reverse
                # complement is the original read)
                seq = query_alignments.query_sequences[0]
                original = seq.complemented_from
                if original is None:
                    forward_flag, reverse_flag, name = 0, FLAG_REVERSE, seq.name
                else:
                    forward_flag, reverse_flag, name = FLAG_REVERSE, 0, original.name
                codes = seq.codes
                entry = len(entries) // 3
                entries += (num_codes, len(codes), len(names))
                names.append(name)
                code_parts.append(codes)
                num_codes += len(codes)
                for rev, ref, off, pen in rows:
                    if ref is not last_ref:
                        last_ref, last_name = ref, name_of(ref)
                    if rev:
                        records.extend((entry, 1, reverse_flag, last_name, off, -1, 0, 0, -1))
                    else:
                        records.extend((entry, 0, forward_flag, last_name, off, -1, 0, 0, -1))
                    penalties.append(pen)
                result_rows.append(len(penalties))
                continue
            components = query_alignments.get_alignments()
            if len(components) == 1:
                # a choice of one component, or a proper pair
                for choice in components[0]:
                    parts = choice.components
                    if len(parts) == 1:
                        part = parts[0]
                        add_row(part, FLAG_REVERSE if part.reference_reversed else 0, None, None)
                        continue
                    for flag, mine, mate in ((pair_flags[0], parts[0], parts[1]), (pair_flags[1], parts[1], parts[0])):
                        if mine.reference_reversed:
                            flag |= FLAG_REVERSE
                        if mate.reference_reversed:
                            flag |= FLAG_MATE_REVERSE
                        add_row(mine, flag, mate, choice.spacing_penalty)
            else:
                # components aligned separately: each aligned one is written
                # with the mate-unmapped flag
                for index, options in enumerate(components):
                    for choice in options:
                        part = choice.components[0]
                        flag = half_flags[0] if index == 0 else half_flags[1]
                        if part.reference_reversed:
                            flag |= FLAG_REVERSE
                        add_row(part, flag, None, choice.spacing_penalty)
            result_rows.append(len(penalties))

        num_rows = len(penalties)
        if not num_rows:
            return [""] * len(results) if by_result else ""
        # each distinct float32 formatted once, as java_float_str does
        values = np.array(penalties + spacings, dtype=np.float32)
        distinct, ids = np.unique(values.view(np.uint32), return_inverse=True)
        numbers = [java_float_str(v) for v in distinct.view(np.float32).tolist()]
        return self._formatter.format_rows(
            names, b"".join(code_parts), entries, records, blocks, ids[:num_rows], ids[num_rows:], numbers,
            result_rows if by_result else None,
        )
