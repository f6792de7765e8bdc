"""The control of the comparison that decides `correct`: the reference put in
the program's place with one of the configuration's guarantees broken.

The control aligns every read (every piece, where the configuration
splits reads) without gaps, at the least-penalty offset of its window on
the plain reference (`reference.align.best_ungapped`), as a scorer would
that never searches for an insertion or deletion: the step a later change
could be tempted by, since the indel rows are what reaches K1.  It writes
the SAM rows such a program would write (a read whose penalty passes the
configuration's error rate is unaligned) and the mutations file or VCF
that the reference sums from them.  Where the configuration writes an
inferred ancestor, the control also stands for a program without ancestor
inference: it writes the plain reference as its ancestor.  The judge must
find it not correct.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...] [--device cuda|cpu]

prints, for each seed, the numbers compared beside the cell's limits, and
exits 1 if any seed's control comes out correct.  Run on the chip at the
cell's own size; `portbench/tests/test_portbench_run.py` runs it small.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from portbench import cells, generate
from portbench.reference import align, judge, pileup, sam


def control_sam(sample, device) -> str:
    """The ungapped control's SAM for the sample (single or paired)."""
    cfg = sample.config
    pen = align.penalties(cfg)
    placed = []
    for reads in judge.units(sample):
        penalty = np.empty(len(reads.names), dtype=np.int64)
        pos = np.empty(len(reads.names), dtype=np.int64)
        for idx, group in judge.by_length(reads):
            lo, width = align.windows(sample.ref.shape[0], group.start, group.span)
            penalty[idx], pos[idx] = align.best_ungapped(sample.ref, judge.forward_codes(group), lo, width, pen,
                                                         device)
        most = cfg["max_error_rate"] * align.SCALE * np.array([len(t) for t in reads.texts])
        placed.append((reads, penalty, pos, penalty <= most))
    lines = ["@HD\tVN:1.6\tSO:unsorted", f"@SQ\tSN:{sample.contig}\tLN:{sample.ref.shape[0]}"]

    def row(reads, k, penalty, pos, flag, rnext="*", pnext=0):
        text = reads.texts[k]
        seq = generate.decode(generate.reverse_complement(generate.encode(text))) if reads.reverse[k] else text
        flag |= sam.FLAG_REVERSE if reads.reverse[k] else 0
        score = np.float32(penalty[k] / align.SCALE)
        return "\t".join([reads.names[k], str(flag), sample.contig, str(int(pos[k]) + 1), "255", f"{len(text)}M",
                          rnext, str(pnext), str(len(text)), seq, "*", f"AS:f:{score}"])

    if len(placed) == 1:
        reads, penalty, pos, ok = placed[0]
        lines += [row(reads, k, penalty, pos, 0) for k in np.nonzero(ok)[0].tolist()]
    else:
        (r1, t1, p1, ok1), (r2, t2, p2, ok2) = placed
        for k in range(len(r1.names)):
            if ok1[k] and ok2[k]:
                base = sam.FLAG_PAIRED | sam.FLAG_PROPER
                m1 = sam.FLAG_MATE_REVERSE if r2.reverse[k] else 0
                m2 = sam.FLAG_MATE_REVERSE if r1.reverse[k] else 0
                lines.append(row(r1, k, t1, p1, base | sam.FLAG_FIRST | m1, sample.contig, int(p2[k]) + 1))
                lines.append(row(r2, k, t2, p2, base | sam.FLAG_SECOND | m2, sample.contig, int(p1[k]) + 1))
            else:
                for mate, (r, t, p, ok) in ((sam.FLAG_FIRST, placed[0]), (sam.FLAG_SECOND, placed[1])):
                    if ok[k]:
                        lines.append(row(r, k, t, p, sam.FLAG_PAIRED | sam.FLAG_MATE_UNMAPPED | mate))
    return "\n".join(lines) + "\n"


def control_outputs(sample, device) -> dict:
    """The control's outputs, its summaries summed by the reference from its
    own SAM, its ancestor the plain reference."""
    cfg = sample.config
    text = control_sam(sample, device)
    outputs = {"sam": text}
    if "ancestor" in cfg["outputs"]:
        outputs["ancestor"] = f">{sample.contig}-anc\n{generate.decode(sample.ref)}\n"
    rows = sam.parse(text)
    p = pileup.pileup(rows, np.ones(len(rows.qname), dtype=bool), sample.ref.shape[0], cfg["query_end_fraction"])
    if "mutations" in cfg["outputs"]:
        outputs["mutations"] = "\n".join(pileup.mutation_lines(p, sample.ref, sample.contig,
                                                               cfg["mutation_thresholds"])) + "\n"
    if "vcf" in cfg["outputs"]:
        outputs["vcf"] = "\n".join(pileup.vcf_lines(p, sample.ref, sample.contig, cfg["vcf_min_depth"])) + "\n"
    return outputs


def run_control(root: Path, workload: str, seed: int, device: str) -> dict:
    """The control's numbers on one seed, each beside the cell's limit."""
    from portbench.run import make_sample

    cell = cells.load(root, workload)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        sample = make_sample(cell, seed, Path(tmp))
    numbers, _ = judge.assess(sample, control_outputs(sample, device), device)
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    passed = 0
    for seed in args.seeds:
        result = run_control(Path.cwd(), args.workload, seed, args.device)
        passed += result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, **result}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
