"""BASELINE config 5's shape (planted repeats, long reads split into
pieces, the inferred ancestor) added as files and an entry alone, run
through the port's CLI on the CPU and judged: a sound run is correct, each
planted fault and the control are not."""

import json
import re

import numpy as np
import pytest

from portbench import cells, control, generate, run
from portbench.reference import ancestor, judge
from portbench.tests.conftest import TINY, copy_bench, shrink

# config 5 as `portbench/README.md` gives it, at its own size; `shrink` cuts
# the reference, the segment and the reads to the tests' size
CONFIG = {
    "name": "long10k",
    "deployment": "BASELINE config 5: 10 kb reads split past 1,500 bp, --infer-ancestors, a 10 Mb reference",
    "source": "https://genomebiology.biomedcentral.com/articles/10.1186/s13059-024-03473-7",
    "reference": {"name": "chr1", "length": 10_000_000,
                  "repeats": {"segment": 50_000, "copies": 3, "snp_rate": 0.02}},
    "reads": {"layout": "single", "count": 2000, "length": 10_000, "split_past": 1500},
    "warmup_reads": 16,
    "cli": ["--split-queries-past-size", "{split_past}", "--queries", "{reads}", "--infer-ancestors",
            "--out-ancestor", "{ancestor}", "--out-sam", "{sam}"],
    "outputs": ["sam", "ancestor"],
    "penalties": {"mutation": 1.0, "ins_open": 1.5, "ins_ext": 0.6, "del_open": 1.5, "del_ext": 0.5,
                  "unaligned": 0.1},
    "max_error_rate": 0.1,
    "query_end_fraction": 0.1,
    "reduced": [],
}
TRAFFIC = {"name": "snp_random_strand", "why": "config 5's reads: 2% SNPs, no indels, each on a random strand",
           "simulator": "simulate_single", "snp_rate": 0.02}
# limits from the CPU's readings at this size: sound runs read every number 0
# but ancestor_columns_missing, 8-22 of about 440 consensus positions; the
# control reads 421-463 there
LIMITS = {"limits": {"failed_jobs": 0, "jobs_differing": 0, "bad_rows": 0, "missing_reads": 0, "penalty_gap": 0.0,
                     "reads_above_optimum": 0, "ancestor_faults": 0, "ancestor_columns_missing": 100}}
WORKLOAD = "long10k_split"
SEED = 2**31 + 77


def add_config5(root):
    """Config 5 as a configuration file, a traffic file, a limits file and
    two entries of `BENCHMARK.json`: nothing of the benchmark edited."""
    pb = root / "portbench"
    (pb / "configs" / "long10k.json").write_text(json.dumps(CONFIG))
    (pb / "traffic" / "snp_random_strand.json").write_text(json.dumps(TRAFFIC))
    (pb / "cells" / f"{WORKLOAD}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "long10k", "source": CONFIG["source"], "file": "portbench/configs/long10k.json",
                             "reduced": [], "why": "BASELINE config 5"})
    bench["workloads"].append({"name": WORKLOAD, "config": "long10k", "traffic": "snp_random_strand", "chips": 1,
                               "why": "10 kb reads in 1,500 bp pieces, the ancestor of a four-copy duplication"})
    for metric in bench["per_layer"]:
        metric["workloads"].append(WORKLOAD)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def c5_root(tmp_path):
    """(a shrunk checkout with config 5 added, the bytes of its benchmark's
    files before config 5 came)."""
    root = copy_bench(tmp_path / "checkout")
    shrink(root)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    add_config5(root)
    shrink(root)  # cuts the new configuration; the shrunk ones stay as they are
    return root, before


def test_shrink_keeps_the_planted_copies_inside_the_reference(c5_root):
    cfg = cells.load(c5_root[0], WORKLOAD).config
    repeats = cfg["reference"]["repeats"]
    assert repeats == {"segment": TINY["segment"], "copies": 3, "snp_rate": 0.02}
    assert (repeats["copies"] + 2) * repeats["segment"] <= cfg["reference"]["length"]
    assert cfg["reads"]["length"] == 10_000 and cfg["reads"]["split_past"] == 1500 and cfg["reads"]["count"] == 12


def test_config5_runs_as_files_and_an_entry_without_edits(c5_root):
    root, before = c5_root
    result = run.run_cell(root, WORKLOAD, SEED, 1, False, "cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] % 12 == 0, result["checks"]
    assert {"ancestor_faults", "ancestor_columns_missing"} <= set(result["checks"])
    assert list(result["checks"])[-1] == "ancestor_columns_missing"
    assert all(before[p] == p.read_bytes() for p in before)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One CPU CLI run of config 5 at the tests' size: (sample, outputs)."""
    root = copy_bench(tmp_path_factory.mktemp("root"))
    add_config5(root)
    shrink(root)
    cell = cells.load(root, WORKLOAD)
    run.environment(root, "cpu")
    from mapper_tpu_torch import cli

    work = tmp_path_factory.mktemp("work")
    sample = run.make_sample(cell, SEED, work)
    (work / "out").mkdir()
    assert cli.main(run.cli_argv(cell.config, sample.files, work / "out", work / "cache")) == 0
    outputs = {name: (work / "out" / run.OUTPUT_FILES[name]).read_text() for name in cell.config["outputs"]}
    return sample, outputs, cell.limits["limits"]


def assess(cli_run, **changed):
    sample, outputs, limits = cli_run
    numbers, _ = judge.assess(sample, {**outputs, **changed}, "cpu")
    return numbers, all(v <= limits[k] for k, v in numbers.items())


def test_every_piece_and_the_ancestor_are_judged(cli_run):
    sample, outputs, _ = cli_run
    pieces = judge.units(sample)[0]
    assert len(pieces.names) == 7 * 12 and {len(t) for t in pieces.texts} == {1428, 1429}
    rows = [line.split("\t")[0] for line in outputs["sam"].splitlines() if not line.startswith("@")]
    assert set(rows) == set(pieces.names)
    numbers, correct = assess(cli_run)
    assert correct and numbers["missing_reads"] == 0 and numbers["bad_rows"] == 0
    # the rows of pieces in the copies are judged against the ancestor's unions
    assert re.search(r"AS:f:\d+\.\d*[1-9]", outputs["sam"]) and outputs["ancestor"].startswith(">chr1-anc\n")


def _fasta(name, codes):
    letters = np.zeros(16, dtype=np.uint8)
    for letter, code in ancestor.IUPAC.items():
        letters[code] = ord(letter)
    return f">{name}\n{letters[codes].tobytes().decode()}\n"


def _body(text):
    lines = text.splitlines(keepends=True)
    return lines, [i for i, line in enumerate(lines) if not line.startswith("@")]


def test_a_dropped_piece_row_is_not_correct(cli_run):
    lines, body = _body(cli_run[1]["sam"])
    numbers, correct = assess(cli_run, sam="".join(line for i, line in enumerate(lines) if i != body[3]))
    assert not correct and numbers["missing_reads"] == 1


def test_a_moved_piece_row_is_not_correct(cli_run):
    lines, body = _body(cli_run[1]["sam"])
    f = lines[body[3]].split("\t")
    f[3] = str(int(f[3]) + 1)
    lines[body[3]] = "\t".join(f)
    numbers, correct = assess(cli_run, sam="".join(lines))
    assert not correct and numbers["bad_rows"] == 1


def test_an_altered_score_is_not_correct(cli_run):
    """A row in a copy, whose AS:f holds the ancestor's ambiguity, scored as
    if against the plain reference."""
    lines, body = _body(cli_run[1]["sam"])
    i = next(i for i in body if re.search(r"AS:f:\d+\.\d*[1-9]", lines[i]))
    lines[i] = re.sub(r"AS:f:([0-9.]+)", lambda m: f"AS:f:{round(float(m.group(1)))}.0", lines[i])
    numbers, correct = assess(cli_run, sam="".join(lines))
    assert not correct and numbers["bad_rows"] == 1


def test_an_ancestor_widened_outside_the_copies_is_not_correct(cli_run):
    name, codes = ancestor.parse_fasta(cli_run[1]["ancestor"])[0]
    codes = codes.copy()
    codes[TINY["segment"] + 500] = 15  # N, after the source segment
    numbers, correct = assess(cli_run, ancestor=_fasta(name, codes))
    assert not correct and numbers["ancestor_faults"] == 1


def test_an_ancestor_widened_to_every_copys_bases_is_not_correct(cli_run):
    """Every copy position widened to the union of the copies' bases in its
    column: bases that one copy alone carries, and copies whose base three
    carry widened, which the walk never writes."""
    sample = cli_run[0]
    name, codes = ancestor.parse_fasta(cli_run[1]["ancestor"])[0]
    planted = sample.planted
    union = np.bitwise_or.reduce(np.stack([sample.ref[s : s + planted.segment] for s in planted.starts]), axis=0)
    codes = codes.copy()
    for s in planted.starts:
        codes[s : s + planted.segment] |= union
    numbers, correct = assess(cli_run, ancestor=_fasta(name, codes))
    assert not correct and numbers["ancestor_faults"] >= len(planted.starts) * planted.segment // 100


@pytest.mark.parametrize("voted, faults", [("mirrored", 0), ("other", 3)])
def test_a_base_the_reverse_strands_walkers_vote_is_sound(voted, faults):
    """A block of the copies whose edges read alike on both strands is
    walked backwards too, and those walkers vote the complement of the
    mirrored column: the base they carry may widen three copies that one
    copy's SNP alone would not; another base may not."""
    rng = np.random.default_rng(11)
    text, planted = generate.planted_reference(rng, 40_000, 2_000, 3, 0.0)
    ref = generate.encode(text)
    a, length = 500, (ref.shape[0] - 1).bit_length()  # the shortest block the duplications hold
    edge = (length + 3) // 4
    c = a + length + 1
    mirror = 2 * a + length - 1 - c
    for s in planted.starts:
        ref[s + a + length - edge : s + a + length] = generate.reverse_complement(ref[s + a : s + a + edge])
    base = int(generate.COMPLEMENT[ref[mirror]])
    own = next(x for x in ancestor.BASES if x != base)
    for s in planted.starts:
        ref[s + c] = own
    ref[planted.starts[1] + c] = base
    assert (a, length) in ancestor.mirrored_blocks(np.stack([ref[s : s + 2_000] for s in planted.starts]),
                                                   ref.shape[0])
    added = base if voted == "mirrored" else next(x for x in ancestor.BASES if x not in (base, own))
    codes = ref.copy()
    for s in (planted.starts[0], planted.starts[2], planted.starts[3]):
        codes[s + c] |= added
    numbers, _ = ancestor.judge(_fasta("chr1-anc", codes), ref, "chr1", planted)
    assert numbers["ancestor_faults"] == faults


def test_an_ancestor_with_its_unions_stripped_is_not_correct(cli_run):
    sample = cli_run[0]
    numbers, correct = assess(cli_run, ancestor=f">chr1-anc\n{generate.decode(sample.ref)}\n")
    assert not correct and numbers["ancestor_faults"] == 0
    assert numbers["ancestor_columns_missing"] > cli_run[2]["ancestor_columns_missing"]
    assert numbers["bad_rows"] > 0  # the rows' AS:f counted the unions


def test_an_ancestor_under_another_name_or_length_is_not_correct(cli_run):
    text = cli_run[1]["ancestor"]
    for altered in (text.replace(">chr1-anc", ">chr1", 1), text.rstrip("\n")[:-1] + "\n"):
        numbers, correct = assess(cli_run, ancestor=altered)
        assert not correct and numbers["ancestor_faults"] == 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(c5_root, seed):
    result = control.run_control(c5_root[0], WORKLOAD, seed, "cpu")
    missing = result["checks"]["ancestor_columns_missing"]
    assert not result["correct"] and missing["value"] > missing["limit"]
    assert result["checks"]["ancestor_faults"]["value"] == 0 and result["checks"]["bad_rows"]["value"] == 0


def test_a_widened_ancestor_written_by_the_program_is_not_correct(c5_root, monkeypatch):
    """A fault planted where the answer is produced: the ancestor's writer
    widens one base outside the copies (the program aligns as before)."""
    from mapper_tpu_torch.io import fastx

    original = fastx.FastaWriter.write

    def widened(self, sequence):
        if sequence.name.endswith("-anc"):
            codes = sequence.codes.copy()
            codes[TINY["segment"] + 500] = 15
            sequence = type(sequence)(sequence.name, codes, path=sequence.path)
        return original(self, sequence)

    monkeypatch.setattr(fastx.FastaWriter, "write", widened)
    result = run.run_cell(c5_root[0], WORKLOAD, SEED, 1, False, "cpu")
    assert not result["correct"] and result["checks"]["ancestor_faults"]["value"] == 1


def test_pieces_cut_as_the_splitter_cuts():
    """`judge.pieces` against `SequenceSplitter` on reads of both strands and
    of lengths that split unevenly or not at all, and the pieces' origins
    hold them."""
    from mapper_tpu_torch.io.fastx import SequenceProvider
    from mapper_tpu_torch.providers import SequenceSplitter
    from mapper_tpu_torch.sequence import SequenceBuilder

    class Texts(SequenceProvider):
        def __init__(self, reads):
            self.left = list(zip(reads.names, reads.texts))

        def get_next_sequence(self):
            if not self.left:
                return None
            name, text = self.left.pop(0)
            return SequenceBuilder().set_name(name).add(text)

        def all_reads_contain_quality_information(self):
            return False

    rng = np.random.default_rng(4)
    ref_text = generate.random_reference(rng, 40_000)
    ref = generate.encode(ref_text)
    for length in (10_000, 3001, 1500):
        reads = generate.simulate_single(rng, ref_text, 6, length, 0.02)
        splitter = SequenceSplitter(1500, Texts(reads))
        want = []
        while (builder := splitter.get_next_sequence()) is not None:
            seq = builder.build()
            want.append((seq.name, seq.get_text()))
        got = judge.pieces(reads, 1500)
        assert list(zip(got.names, got.texts)) == want and len(want) == 6 * -(-length // 1500)
        assert got.reverse.any() and not got.reverse.all()
        for k, text in enumerate(got.texts):
            codes = generate.encode(text)
            if got.reverse[k]:
                codes = generate.reverse_complement(codes)
            assert got.span[k] == len(text)
            assert (codes != ref[got.start[k] : got.start[k] + len(text)]).sum() < 0.05 * len(text)


def test_pieces_of_gapped_reads_align_in_their_windows():
    """With a planted indel in every read, each piece still aligns whole
    inside its window, which the read's indel widens: its optimum is no more
    than its SNPs and one indel cost."""
    from portbench.reference import align

    rng = np.random.default_rng(6)
    ref_text = generate.random_reference(rng, 60_000)
    reads = generate.simulate_reads(rng, ref_text, 10, 3000, 0.0, 1.0)
    assert (reads.span != 3000).all() and reads.reverse.any()
    got = judge.pieces(reads, 1500)
    pen = align.penalties({"penalties": CONFIG["penalties"]})
    ref = generate.encode(ref_text)
    for idx, group in judge.by_length(got):
        lo, width = align.windows(ref.shape[0], group.start, group.span)
        best = align.glocal_optimum(ref, judge.forward_codes(group), lo, width, pen, "cpu")
        assert (best <= pen["del_open"] + 3 * pen["ins_ext"]).all(), best
