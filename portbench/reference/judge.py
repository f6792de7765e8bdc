"""The numbers that decide `correct`, each worked out from the generated
inputs and one job's outputs.

- `bad_rows`: SAM rows that are not sound alignments of their read (see
  `sam.py`), plus lines that are not rows at all.
- `missing_reads`: reads of the sample with no sound row.
- `penalty_gap`: the widest gap by which a read's least row penalty lies
  above the least penalty of any alignment near its origin
  (`align.glocal_optimum`).
- `reads_above_optimum`: reads whose least row penalty lies above that
  optimum by any amount: a fault that leaves many reads a little worse.
- `mutation_lines_differing` / `vcf_lines_differing`: lines of the
  mutations file or VCF that differ from those the reference sums from the
  sound rows (`pileup.py`), counted over both sides.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from portbench.generate import COMPLEMENT, encode
from portbench.reference import align, pileup, sam


def forward_codes(reads) -> np.ndarray:
    """[R, L] codes of each read in the forward strand's orientation."""
    out = np.stack([encode(t) for t in reads.texts])
    out[reads.reverse] = COMPLEMENT[out[reads.reverse][:, ::-1]]
    return out


def optimum(sample, device) -> np.ndarray:
    """The reference's least penalty (tenths) of every read of the sample,
    mates in turn for pairs."""
    pen = align.penalties(sample.config)
    result = []
    for reads in sample.reads:
        lo, width = align.windows(sample.ref.shape[0], reads.start, reads.span)
        result.append(align.glocal_optimum(sample.ref, forward_codes(reads), lo, width, pen, device))
    return np.concatenate(result)


def _differing(got: list[str], want: list[str]) -> int:
    if got == want:
        return 0
    diff = Counter(got)
    diff.subtract(Counter(want))
    return sum(abs(v) for v in diff.values())


def _body(text: str) -> list[str]:
    return [line for line in text.splitlines() if line and not line.startswith("#") and not line.startswith("CHR\t")]


def judge(sample, outputs: dict, best: np.ndarray) -> dict:
    """`outputs`: name -> text of one job's files (`sam`, and `mutations` or
    `vcf`); `best`: `optimum(sample, ...)`.  Returns the numbers compared."""
    cfg = sample.config
    pen = align.penalties(cfg)
    names, texts = {}, []
    for reads in sample.reads:
        for name, text in zip(reads.names, reads.texts):
            names[name] = len(texts)
            texts.append(text)
    rows = sam.parse(outputs["sam"])
    tenths = sam.row_penalties(rows, sample.ref, sample.contig, pen)
    bad = (tenths < 0) | sam.seq_faults(rows, names, texts) | sam.mate_faults(rows)
    bad |= np.abs(rows.score * 10 - tenths) > 1e-3
    usable = ~bad
    least = np.full(len(texts), np.iinfo(np.int64).max)
    for i in np.nonzero(usable)[0].tolist():
        k = names[rows.qname[i]]
        least[k] = min(least[k], int(tenths[i]))
    found = least != np.iinfo(np.int64).max
    gap = np.where(found, least - best, 0)
    numbers = {
        "bad_rows": int(bad.sum()) + rows.malformed,
        "missing_reads": int((~found).sum()),
        "penalty_gap": float(max(int(gap.max(initial=0)), 0)) / 10,
        "reads_above_optimum": int((gap > 0).sum()),
    }
    if "mutations" in outputs or "vcf" in outputs:
        p = pileup.pileup(rows, usable, sample.ref.shape[0], cfg["query_end_fraction"])
        if "mutations" in outputs:
            want = pileup.mutation_lines(p, sample.ref, sample.contig, cfg["mutation_thresholds"])
            numbers["mutation_lines_differing"] = _differing(_body(outputs["mutations"]), want)
        if "vcf" in outputs:
            want = pileup.vcf_lines(p, sample.ref, sample.contig, cfg["vcf_min_depth"])
            numbers["vcf_lines_differing"] = _differing(_body(outputs["vcf"]), want)
    return numbers
