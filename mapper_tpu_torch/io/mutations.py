"""Per-mutation summary output (reference: QuickVariants MutationsWriter;
format pinned by MutationsWriter_Test.java:32-134):

    CHR  POS(1-based)  REF  ALT  DEPTH  SUPPORT_FRACTION
    SNP:        ref  6  A   T    1  1
    insertion:  ref  3  --  GA   1  1   (POS = base the insertion follows)
    deletion:   ref  7  AG  --   1  1   (POS = first deleted base;
                                         left-justified placement)

Thresholds (MutationDetectionParameters; defaults from Mapper.java:56,
README.md:73-84): SNPs gated by total depth + supporting fraction; indels by
middle-of-read depth at the start position, with a separate continuation
threshold for each additional indel position.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.pileup import ROW_AMB, ROW_DEL, ROW_CHARS, ContigPileup
from mapper_tpu_torch.sequence import Sequence


@dataclass
class MutationDetectionParameters:
    """MutationDetectionParameters (statics per Mapper.java:56-57)."""

    min_snp_total_depth: float = 0.0
    min_snp_depth_fraction: float = 0.0
    min_indel_total_start_depth: float = 0.0
    min_indel_start_depth_fraction: float = 0.0
    min_indel_continuation_total_depth: float = 0.0
    min_indel_continuation_depth_fraction: float = 0.0

    @staticmethod
    def default_filter() -> "MutationDetectionParameters":
        return MutationDetectionParameters(5, 0.9, 1, 0.8, 1, 0.7)

    @staticmethod
    def empty_filter() -> "MutationDetectionParameters":
        return MutationDetectionParameters()


def format_number(x: float) -> str:
    """Depth/fraction columns print integers without a decimal point."""
    if x == int(x):
        return str(int(x))
    return repr(round(float(x), 6)).rstrip("0").rstrip(".")


class MutationsWriter:
    def __init__(self, stream_or_path, parameters: MutationDetectionParameters):
        if isinstance(stream_or_path, str):
            self.stream = open(stream_or_path, "wt", encoding="ascii")
            self._owns = True
        else:
            self.stream = stream_or_path
            self._owns = False
        self.parameters = parameters

    def write(self, pileups: dict[Sequence, ContigPileup], num_threads: int = 1) -> None:
        self.stream.write(
            "# Mutations detected by mapper_tpu\n"
            "# SNP rows:       CHR POS REF ALT DEPTH SUPPORT_FRACTION\n"
            "# insertion rows: REF is '-' per inserted base; POS is the base the insertion follows\n"
            "# deletion rows:  ALT is '-' per deleted base; POS is the first deleted base\n"
        )
        self.stream.write("CHR\tPOS\tREF\tALT\tDEPTH\tSUPPORT_FRACTION\n")
        items = list(pileups.items())
        if num_threads > 1 and len(items) > 1:
            # contig-parallel formatting (MutationsWriter.write(…, numThreads),
            # Mapper.java:783); buffered per contig so output order is stable
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                for text in pool.map(
                    lambda sp: self._format_contig(sp[0], sp[1]), items
                ):
                    self.stream.write(text)
        else:
            for sequence, pileup in items:
                self.stream.write(self._format_contig(sequence, pileup))
        if self._owns:
            self.stream.close()

    def _format_contig(self, sequence: Sequence, pileup: ContigPileup) -> str:
        p = self.parameters
        n = len(sequence)
        ref_codes = sequence.codes
        totals = pileup.middle[:ROW_DEL].sum(axis=0) + pileup.end[:ROW_DEL].sum(axis=0)
        combined = pileup.middle + pileup.end
        middle_totals = pileup.middle.sum(axis=0)

        rows: list[tuple[int, int, str]] = []  # (position, order, line)

        # SNPs: non-reference concrete alleles passing the thresholds
        for row in range(4):
            allele_char = ROW_CHARS[row]
            allele_code = basepairs.encode(allele_char)[0]
            weights = combined[row]
            candidates = np.nonzero(weights > 0)[0]
            for pos in candidates:
                if ref_codes[pos] == allele_code:
                    continue
                depth = totals[pos] + combined[ROW_DEL, pos]
                support = weights[pos]
                if depth < p.min_snp_total_depth:
                    continue
                if depth <= 0 or support / depth < p.min_snp_depth_fraction:
                    continue
                line = "\t".join(
                    [
                        sequence.name,
                        str(pos + 1),
                        basepairs.decode_one(int(ref_codes[pos])),
                        allele_char,
                        format_number(depth),
                        format_number(support / depth),
                    ]
                )
                rows.append((int(pos), 1, line))

        # deletions: start where the middle-of-read deletion support passes the
        # start thresholds, extend while continuation passes
        del_middle = pileup.middle[ROW_DEL]
        starts = np.nonzero(pileup.deletion_start_middle > 0)[0]
        for start in starts:
            support = pileup.deletion_start_middle[start]
            depth = middle_totals[start]
            if depth < p.min_indel_total_start_depth:
                continue
            if depth <= 0 or support / depth < p.min_indel_start_depth_fraction:
                continue
            end = start + 1
            while end < n and del_middle[end] > 0:
                cont_depth = middle_totals[end]
                cont_support = del_middle[end]
                if cont_depth < p.min_indel_continuation_total_depth:
                    break
                if cont_depth <= 0 or cont_support / cont_depth < p.min_indel_continuation_depth_fraction:
                    break
                end += 1
            deleted_text = sequence.get_range(int(start), int(end - start))
            line = "\t".join(
                [
                    sequence.name,
                    str(start + 1),
                    deleted_text,
                    "-" * (end - start),
                    format_number(depth),
                    format_number(support / depth if depth > 0 else 0.0),
                ]
            )
            rows.append((int(start), 2, line))

        # insertions: events keyed by (position, text); middle-of-read support
        # passing the start thresholds
        for (pos, text), (middle_w, end_w, *_example) in sorted(pileup.insertions.items()):
            if middle_w <= 0:
                continue
            depth = middle_totals[pos] if pos < n else middle_totals[n - 1]
            depth = max(depth, middle_w)
            if depth < p.min_indel_total_start_depth:
                continue
            if depth <= 0 or middle_w / depth < p.min_indel_start_depth_fraction:
                continue
            line = "\t".join(
                [
                    sequence.name,
                    str(pos),
                    "-" * len(text),
                    text,
                    format_number(depth),
                    format_number(middle_w / depth),
                ]
            )
            rows.append((int(pos), 0, line))

        return "".join(
            line + "\n" for _, _, line in sorted(rows, key=lambda r: (r[0], r[1]))
        )
