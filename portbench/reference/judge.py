"""The numbers that decide `correct`, each worked out from the generated
inputs and one job's outputs.

A read is judged as the program aligns it: where the configuration splits
reads past `reads.split_past` bases (`--split-queries-past-size`), each
piece is a read of its own, cut as X-Mapper's SequenceSplitter cuts it, and
every number below counts pieces.  Where the configuration writes an
inferred ancestor (`--out-ancestor`), rows are judged against it once
`ancestor.py` has checked it, and that adds two numbers of its own
(`ancestor_faults`, `ancestor_columns_missing`).

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

from portbench.generate import COMPLEMENT, Reads, encode
from portbench.reference import align, ancestor, pileup, sam


def pieces(reads: Reads, max_size: int) -> Reads:
    """SequenceSplitter's cut: a read of L > `max_size` bases becomes num =
    ceil(L / max_size) pieces, piece i covering [L(i-1)//num, Li//num) of
    the text as written and named `<name>_<first base>`; a shorter read
    stays whole, under its own name.  A piece's origin is its forward-strand
    bases (cut from the far end of a reversed read), widened on each side by
    the read's planted indel, which shifts the pieces after it."""
    names, texts, start, span = [], [], [], []
    reverse = []
    for k, (name, text) in enumerate(zip(reads.names, reads.texts)):
        n = len(text)
        num = -(-n // max_size)
        slack = abs(int(reads.span[k]) - n)
        for i in range(1, num + 1):
            a, b = n * (i - 1) // num, n * i // num
            names.append(f"{name}_{a}" if num > 1 else name)
            texts.append(text[a:b])
            start.append(int(reads.start[k]) + (n - b if reads.reverse[k] else a) - slack)
            span.append(b - a + 2 * slack)
            reverse.append(bool(reads.reverse[k]))
    return Reads(names, texts, np.array(start, dtype=np.int64), np.array(span, dtype=np.int64),
                 np.array(reverse, dtype=bool))


def units(sample) -> list[Reads]:
    """What the program aligns, mates in turn for pairs: the reads, or with
    `reads.split_past` their pieces."""
    split = sample.config["reads"].get("split_past")
    return [pieces(reads, split) for reads in sample.reads] if split else list(sample.reads)


def owners(sample) -> np.ndarray:
    """The read (over the mates in turn) that each of `units` comes from."""
    split = sample.config["reads"].get("split_past")
    counts = [-(-len(t) // split) if split else 1 for reads in sample.reads for t in reads.texts]
    return np.repeat(np.arange(len(counts)), counts)


def by_length(reads: Reads):
    """(indices, their reads as a `Reads`) for each read length, so that
    reads of one length stack into one [R, L] array."""
    lengths = np.array([len(t) for t in reads.texts])
    for length in np.unique(lengths):
        idx = np.nonzero(lengths == length)[0]
        yield idx, Reads([reads.names[i] for i in idx], [reads.texts[i] for i in idx], reads.start[idx],
                         reads.span[idx], reads.reverse[idx])


def forward_codes(reads) -> np.ndarray:
    """[R, L] codes of each read (all of one length) in the forward strand's
    orientation."""
    out = np.stack([encode(t) for t in reads.texts])
    out[reads.reverse] = COMPLEMENT[out[reads.reverse][:, ::-1]]
    return out


def optimum(sample, device, ref: np.ndarray | None = None) -> np.ndarray:
    """The least penalty (units of 1/`align.SCALE`) of every one of `units`
    against `ref` (the sample's reference by default)."""
    ref = sample.ref if ref is None else ref
    pen = align.penalties(sample.config)
    result = []
    for reads in units(sample):
        best = np.empty(len(reads.names), dtype=np.int64)
        for idx, group in by_length(reads):
            lo, width = align.windows(ref.shape[0], group.start, group.span)
            best[idx] = align.glocal_optimum(ref, forward_codes(group), lo, width, pen, device)
        result.append(best)
    return np.concatenate(result)


def assess(sample, outputs: dict, device) -> tuple[dict, int]:
    """(the numbers compared, the reads with a piece that has no sound row)
    for one job's `outputs`, the optimum worked out here: against the
    checked ancestor where the configuration writes one."""
    if "ancestor" not in sample.config["outputs"]:
        numbers, found = _judge(sample, outputs, optimum(sample, device), sample.ref)
    else:
        extra, checked = ancestor.judge(outputs.get("ancestor", ""), sample.ref, sample.contig, sample.planted)
        numbers, found = _judge(sample, outputs, optimum(sample, device, checked), checked)
        numbers.update(extra)
    return numbers, int(np.unique(owners(sample)[~found]).shape[0])


def _differing(got: list[str], want: list[str]) -> int:
    if got == want:
        return 0
    diff = Counter(got)
    diff.subtract(Counter(want))
    return sum(abs(v) for v in diff.values())


def _body(text: str) -> list[str]:
    return [line for line in text.splitlines() if line and not line.startswith("#") and not line.startswith("CHR\t")]


def _judge(sample, outputs: dict, best: np.ndarray, ref: np.ndarray) -> tuple[dict, np.ndarray]:
    """(the numbers, which of `units` have a sound row) of `outputs` (name
    -> text of one job's files: `sam`, and `mutations` or `vcf`), the rows
    judged against `ref` and `best`, `optimum(sample, ..., ref)`.  Callers
    go through `assess`, which works out `best`; the reference's tests pass
    one they keep."""
    cfg = sample.config
    pen = align.penalties(cfg)
    names, texts = {}, []
    for reads in units(sample):
        for name, text in zip(reads.names, reads.texts):
            names[name] = len(texts)
            texts.append(text)
    rows = sam.parse(outputs["sam"])
    penalty = sam.row_penalties(rows, ref, sample.contig, pen)
    bad = (penalty < 0) | sam.seq_faults(rows, names, texts) | sam.mate_faults(rows)
    bad |= np.abs(rows.score * align.SCALE - penalty) > 1e-4 * align.SCALE  # AS:f's float32 rounding passes
    usable = ~bad
    least = np.full(len(texts), np.iinfo(np.int64).max)
    for i in np.nonzero(usable)[0].tolist():
        k = names[rows.qname[i]]
        least[k] = min(least[k], int(penalty[i]))
    found = least != np.iinfo(np.int64).max
    gap = np.where(found, least - best, 0)
    numbers = {
        "bad_rows": int(bad.sum()) + rows.malformed,
        "missing_reads": int((~found).sum()),
        "penalty_gap": float(max(int(gap.max(initial=0)), 0)) / align.SCALE,
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
    return numbers, found
