"""Per-position summary output (reference: QuickVariants VcfWriter; the format
is documented in the file header it writes — the upstream source is in the
absent QuickVariants submodule, so this implementation defines and documents
an equivalent column set with the features the CLI exposes:

- one row per covered reference position (--vcf-exclude-non-mutations drops
  rows whose observed alleles all match the reference),
- middle-of-read and end-of-read depths reported separately
  (--distinguish-query-ends),
- observed alleles with their weights,
- one supporting read name per row unless --vcf-omit-support-reads.
"""

from __future__ import annotations

import numpy as np

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.io.mutations import MutationDetectionParameters, format_number
from mapper_tpu_torch.pileup import ROW_AMB, ROW_CHARS, ROW_DEL, ContigPileup
from mapper_tpu_torch.sequence import Sequence

_HEADER = """\
## Per-position alignment summary
## Columns:
##   CHR, POS (1-based), REF: the reference position
##   DEPTH_MIDDLE / DEPTH_END: aligned weight from the middle / ends of reads
##   ALLELES: observed alleles as allele=middleWeight+endWeight, ';'-separated
##            ('-' = deletion; 'ins:TEXT' = insertion following this position)
##   SUPPORT: name of one supporting read (omitted with --vcf-omit-support-reads)
"""


class VcfWriter:
    def __init__(
        self,
        stream_or_path,
        include_non_mutations: bool,
        parameters: MutationDetectionParameters,
        show_support_read: bool,
    ):
        if isinstance(stream_or_path, str):
            self.stream = open(stream_or_path, "wt", encoding="ascii")
            self._owns = True
        else:
            self.stream = stream_or_path
            self._owns = False
        self.include_non_mutations = include_non_mutations
        self.parameters = parameters
        self.show_support_read = show_support_read
        self.num_reference_positions_matched = 0

    def get_num_reference_positions_matched(self) -> int:
        return self.num_reference_positions_matched

    def write(self, pileups: dict[Sequence, ContigPileup], num_threads: int = 1) -> None:
        """Writes all contigs.  num_threads > 1 formats contigs in parallel
        (the reference's VcfWriter.write(alignments, numThreads),
        Mapper.java:764) — output order stays deterministic because each
        contig's text is buffered and emitted in input order."""
        self.stream.write(_HEADER)
        columns = ["CHR", "POS", "REF", "DEPTH_MIDDLE", "DEPTH_END", "ALLELES"]
        if self.show_support_read:
            columns.append("SUPPORT")
        self.stream.write("#" + "\t".join(columns) + "\n")
        items = list(pileups.items())
        if num_threads > 1 and len(items) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                texts = list(
                    pool.map(lambda sp: self._format_contig(sp[0], sp[1]), items)
                )
            for text, matched in texts:
                self.num_reference_positions_matched += matched
                self.stream.write(text)
        else:
            for sequence, pileup in items:
                text, matched = self._format_contig(sequence, pileup)
                self.num_reference_positions_matched += matched
                self.stream.write(text)
        if self._owns:
            self.stream.close()

    def _format_contig(self, sequence: Sequence, pileup: ContigPileup) -> tuple[str, int]:
        p = self.parameters
        middle_depth = pileup.middle.sum(axis=0)
        end_depth = pileup.end.sum(axis=0)
        total = middle_depth + end_depth
        covered_mask = total > 0
        matched = int(np.count_nonzero(covered_mask))

        insertions_by_pos: dict[int, list[tuple[str, float, float, str]]] = {}
        for (pos, text), (mid_w, end_w, example, *_gid) in pileup.insertions.items():
            insertions_by_pos.setdefault(pos, []).append((text, mid_w, end_w, example))

        # --- vectorized fast path: positions whose only observed allele is
        # the (unambiguous) reference base and that have no insertions; on
        # covered genomes this is nearly every row ---------------------------
        from mapper_tpu_torch.pileup import _CODE_TO_ROW

        present = (pileup.middle > 0) | (pileup.end > 0)
        n_alleles = present.sum(axis=0)
        ref_row = _CODE_TO_ROW[sequence.codes].astype(np.int64)
        is_acgt = np.isin(sequence.codes, (1, 2, 4, 8))
        npos = total.shape[0]
        ref_present = present[ref_row, np.arange(npos)]
        has_ins = np.zeros(npos, dtype=bool)
        if insertions_by_pos:
            has_ins[np.fromiter(insertions_by_pos, dtype=np.int64)] = True
        simple = (
            covered_mask & is_acgt & (n_alleles == 1) & ref_present & ~has_ins
        )

        # every row is "<name>\t<pos+1><suffix>"; there are few distinct
        # suffixes among simple rows, plus one per complex row
        supp = "\t." if self.show_support_read else ""
        suffixes: list[str] = []
        simple_pos = np.zeros(0, dtype=np.int64)
        simple_ids = np.zeros(0, dtype=np.int32)
        if self.include_non_mutations:
            keep = simple & (total >= p.min_snp_total_depth)
            simple_pos = np.nonzero(keep)[0]
            if simple_pos.shape[0]:
                simple_ids = self._simple_suffix_ids(
                    ref_row[simple_pos],
                    middle_depth[simple_pos],
                    end_depth[simple_pos],
                    supp,
                    suffixes,
                )

        # --- exact per-position path for everything else ---------------------
        # bulk-extract the complex columns once (per-element numpy scalar
        # access is ~10x slower than iterating plain Python floats), and
        # memoize the number formatting (depth values repeat heavily)
        complex_pos_list: list[int] = []
        cpos = np.nonzero(covered_mask & ~simple)[0]
        if cpos.shape[0]:
            mid_rows = pileup.middle[:, cpos].T.tolist()
            end_rows = pileup.end[:, cpos].T.tolist()
            ref_chars = basepairs.decode(sequence.codes[cpos])
            total_c = total[cpos].tolist()
            midd_c = middle_depth[cpos].tolist()
            endd_c = end_depth[cpos].tolist()
            fmt_cache: dict[float, str] = {}

            def fmt(v: float) -> str:
                s = fmt_cache.get(v)
                if s is None:
                    s = fmt_cache[v] = format_number(v)
                return s

            min_depth = p.min_snp_total_depth
            include_all = self.include_non_mutations
            for i, pos in enumerate(cpos.tolist()):
                ref_char = ref_chars[i]
                mid6 = mid_rows[i]
                end6 = end_rows[i]
                alleles = []
                is_mutation = False
                for row in range(6):
                    mid_w = mid6[row]
                    end_w = end6[row]
                    if mid_w + end_w <= 0:
                        continue
                    char = ROW_CHARS[row]
                    if char != ref_char:
                        is_mutation = True
                    alleles.append(f"{char}={fmt(mid_w)}+{fmt(end_w)}")
                for text, mid_w, end_w, _example in insertions_by_pos.get(pos, []):
                    is_mutation = True
                    alleles.append(f"ins:{text}={fmt(mid_w)}+{fmt(end_w)}")
                if not is_mutation and not include_all:
                    continue
                if total_c[i] < min_depth:
                    continue
                complex_pos_list.append(pos)
                suffixes.append(
                    f"\t{ref_char}\t{fmt(midd_c[i])}"
                    f"\t{fmt(endd_c[i])}\t{';'.join(alleles)}{supp}\n"
                )

        # merge the two (each position-sorted) streams back into one order
        n_simple = simple_pos.shape[0]
        n_complex = len(complex_pos_list)
        if n_complex:
            complex_pos = np.array(complex_pos_list, dtype=np.int64)
            complex_ids = np.arange(
                len(suffixes) - n_complex, len(suffixes), dtype=np.int32
            )
            merged_pos = np.empty(n_simple + n_complex, dtype=np.int64)
            merged_ids = np.empty(n_simple + n_complex, dtype=np.int32)
            s_idx = np.arange(n_simple) + np.searchsorted(complex_pos, simple_pos)
            c_idx = np.arange(n_complex) + np.searchsorted(simple_pos, complex_pos)
            merged_pos[s_idx] = simple_pos
            merged_ids[s_idx] = simple_ids
            merged_pos[c_idx] = complex_pos
            merged_ids[c_idx] = complex_ids
        else:
            merged_pos = simple_pos
            merged_ids = simple_ids
        if merged_pos.shape[0] == 0:
            return "", matched

        from mapper_tpu_torch.native import native_format_rows

        name = sequence.name
        text = native_format_rows(name + "\t", merged_pos + 1, merged_ids, suffixes)
        if text is None:
            text = "".join(
                f"{name}\t{pos}{suffixes[j]}"
                for pos, j in zip((merged_pos + 1).tolist(), merged_ids.tolist())
            )
        return text, matched

    @staticmethod
    def _simple_suffix_ids(
        rows: np.ndarray,
        mid: np.ndarray,
        end: np.ndarray,
        supp: str,
        suffixes: list[str],
    ) -> np.ndarray:
        """Appends the distinct simple-row suffixes to `suffixes` and returns
        each row's suffix index.  Depths are almost always half-integers
        (weights 1.0 and 0.5), so the common case builds a dense integer key
        and avoids any sort."""
        mid2 = mid * 2.0
        end2 = end * 2.0
        mid2i = mid2.astype(np.int64)
        end2i = end2.astype(np.int64)
        base = len(suffixes)
        if np.array_equal(mid2i, mid2) and np.array_equal(end2i, end2):
            m_card = int(mid2i.max()) + 1
            e_card = int(end2i.max()) + 1
            if 6 * m_card * e_card <= 1 << 22:
                key = (rows * m_card + mid2i) * e_card + end2i
                counts = np.bincount(key, minlength=6 * m_card * e_card)
                lut = np.cumsum(counts > 0, dtype=np.int64) - 1
                for k in np.nonzero(counts)[0].tolist():
                    e_i = k % e_card
                    rest = k // e_card
                    rc = ROW_CHARS[int(rest // m_card)]
                    ms = format_number((rest % m_card) / 2.0)
                    es = format_number(e_i / 2.0)
                    suffixes.append(f"\t{rc}\t{ms}\t{es}\t{rc}={ms}+{es}{supp}\n")
                return (base + lut[key]).astype(np.int32)
        # general case: fractional depths (e.g. 1/3 weights); sort-based dedup
        mid_u, mid_inv = np.unique(mid, return_inverse=True)
        end_u, end_inv = np.unique(end, return_inverse=True)
        key = (rows * mid_u.shape[0] + mid_inv) * end_u.shape[0] + end_inv
        key_u, inverse = np.unique(key, return_inverse=True)
        for k in key_u.tolist():
            e_i = k % end_u.shape[0]
            rest = k // end_u.shape[0]
            m_i = rest % mid_u.shape[0]
            rc = ROW_CHARS[int(rest // mid_u.shape[0])]
            ms = format_number(float(mid_u[m_i]))
            es = format_number(float(end_u[e_i]))
            suffixes.append(f"\t{rc}\t{ms}\t{es}\t{rc}={ms}+{es}{supp}\n")
        return (base + inverse).astype(np.int32)
