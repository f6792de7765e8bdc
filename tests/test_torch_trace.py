"""The port's spans and counters (`mapper_tpu_torch/trace.py`): tiny CLI runs
on the CPU, single-end, paired, and long reads split into pieces against an
inferred ancestor, traced with `MAPPER_TPU_TRACE=1` and not; the `[trace]`
line's form, the spans' nesting and names, the counters (the pileup's, the
splitter's, the ancestry inference's and the duplication scan's among
them), and outputs that tracing leaves byte for byte as they were."""

import contextlib
import io
import json
import threading

import numpy as np
import pytest

from benchmarks.simlib import mutate, random_reference, rc_text, write_reference
from mapper_tpu_torch import cli, trace
from mapper_tpu_torch.index.ancestry import AncestryDetector
from mapper_tpu_torch.simulate import simulate_reads, write_fastq

OUTPUTS = {"--out-sam": "out.sam", "--out-mutations": "mutations.txt", "--out-vcf": "out.vcf"}
CLI_SPANS = {"cli.main", "cli.reference", "cli.index", "cli.engine", "cli.dup_scan", "cli.dup_wait", "cli.align",
             "cli.parse", "cli.wait", "cli.listeners", "cli.pileup", "cli.write", "cli.report"}
ENGINE_SPANS = {"engine.batch", "engine.cache", "engine.triage", "engine.candidates", "engine.certificate",
                "engine.dispatch", "engine.fetch", "engine.decide", "engine.fallback"}
ANCESTRY_SPANS = {"ancestry.source_index", "ancestry.detect", "ancestry.walk", "ancestry.emit", "ancestry.index"}
# every span the port records: README.md's table
DOCUMENTED = CLI_SPANS | ENGINE_SPANS | ANCESTRY_SPANS | {"engine.pairing", "engine.pair_exact"}
LEGACY = "[engine] decisions+emit: "
KINDS = ("single", "paired", "ancestry")
SPLIT = 1500
# the long reads' lengths: at, under and past the split size
LONG_LENGTHS = (900, 1500, 1501, 2999, 3000, 4100)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_inputs")
    rng = np.random.default_rng(5)
    ref = random_reference(rng, 40_000)
    write_reference(str(root / "ref.fasta"), {"chrA": ref[:25_000], "chrB": ref[25_000:]})
    reads = simulate_reads(rng, ref, 300, 150, snp_rate=0.01, indel_fraction=0.2)
    reads += [(f"u{i}", random_reference(rng, 150)) for i in range(8)]  # unalignable: the exact worker's
    write_fastq(root / "reads.fastq", reads)
    mates1, mates2 = [], []
    for i in range(60):
        pos = int(rng.integers(0, 24_000 - 400))
        frag = ref[pos : pos + int(rng.integers(300, 360))]
        # a 2 bp deletion in every third first mate: rows the certificate
        # leaves to the scorer
        mates1.append((f"p{i}/1", frag[:40] + frag[42:102] if i % 3 == 0 else frag[:100]))
        mates2.append((f"p{i}/2", rc_text(frag[-100:])))
    write_fastq(root / "m1.fastq", mates1)
    write_fastq(root / "m2.fastq", mates2)
    # a reference whose first 4 kb has three copies at 2% SNPs (config 5's
    # shape, BASELINE.md), and long reads of both strands, two of each length
    base = random_reference(rng, 36_000)
    segment = np.array(list(base[:4000]))
    planted = base + "".join("".join(mutate(rng, segment, 0.02)) for _ in range(3))
    write_reference(str(root / "planted.fasta"), {"chrA": planted})
    long_reads = []
    for length in LONG_LENGTHS:
        for k in range(2):
            pos = int(rng.integers(0, len(planted) - length))
            text = "".join(mutate(rng, np.array(list(planted[pos : pos + length])), 0.02))
            long_reads.append((f"l{length}_{k}", rc_text(text) if k else text))
    write_fastq(root / "long.fastq", long_reads)
    return root


def _pieces(length):
    return -(-length // SPLIT) if length > SPLIT else 1


def _query_args(inputs, kind):
    """(reference, the query flags, queries the engine sees)."""
    if kind == "single":
        return inputs / "ref.fasta", ["--queries", str(inputs / "reads.fastq")], 308
    if kind == "paired":
        return inputs / "ref.fasta", ["--paired-queries", str(inputs / "m1.fastq"), str(inputs / "m2.fastq"),
                                      "--spacing", "100", "50"], 60
    return inputs / "planted.fasta", ["--split-queries-past-size", str(SPLIT), "--queries",
                                      str(inputs / "long.fastq"), "--infer-ancestors"], \
        2 * sum(_pieces(n) for n in LONG_LENGTHS)


def _outputs(kind):
    return {**OUTPUTS, "--out-ancestor": "ancestor.fasta"} if kind == "ancestry" else OUTPUTS


def _run(inputs, out_dir, kind, traced, sam="file"):
    """One CLI run: (outputs' bytes, stdout, stderr)."""
    out_dir.mkdir()
    reference, query_args, _ = _query_args(inputs, kind)
    args = ["--reference", str(reference), *query_args, "--devices", "1"]
    for flag, name in _outputs(kind).items():
        args += [flag, "-" if (flag == "--out-sam" and sam == "stdout") else str(out_dir / name)]
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
        if traced:
            mp.setenv("MAPPER_TPU_TRACE", "1")
        else:
            mp.delenv("MAPPER_TPU_TRACE", raising=False)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert cli.main(args) == 0
    files = {name: (out_dir / name).read_bytes() for name in _outputs(kind).values() if (out_dir / name).exists()}
    return files, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Each kind traced and untraced, a traced single-end run with the SAM
    on stdout, and the ancestry detector of the traced ancestry run."""
    root = tmp_path_factory.mktemp("trace_runs")
    done = {}
    seen = []
    original = AncestryDetector.get_hashblock_database

    def keep(detector):
        seen.append(detector)
        return original(detector)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AncestryDetector, "get_hashblock_database", keep)
        for kind in KINDS:
            for traced in (False, True):
                done[kind, traced] = _run(inputs, root / f"{kind}_{traced}", kind, traced)
    done["single", "stdout"] = _run(inputs, root / "single_stdout", "single", True, sam="stdout")
    (done["ancestry", "detector"],) = seen[1:]  # the traced run's (the untraced run's is first)
    return done


def _trace_lines(stderr):
    return [json.loads(line[len("[trace] "):]) for line in stderr.splitlines() if line.startswith("[trace] ")]


def _spans(stderr):
    (record,) = _trace_lines(stderr)
    return record, [dict(zip(("name", "thread", "t0", "t1", "cpu", "parent", "batch"), s)) for s in record["spans"]]


@pytest.mark.parametrize("kind", KINDS)
def test_untraced_run_writes_no_trace_line(runs, kind, monkeypatch):
    _, stdout, stderr = runs[kind, False]
    assert "[trace]" not in stderr and LEGACY not in stdout
    monkeypatch.delenv("MAPPER_TPU_TRACE", raising=False)
    tracer = trace.recorder()
    assert tracer is trace.OFF and tracer.span("cli.main") is trace.NOOP and tracer.span("x", batch=3) is trace.NOOP
    assert tracer.count("reads.single", 1) is None


@pytest.mark.parametrize("kind", KINDS)
def test_traced_run_writes_the_untraced_bytes(runs, kind):
    plain, traced = runs[kind, False][0], runs[kind, True][0]
    assert set(plain) == set(_outputs(kind).values()) and plain == traced


@pytest.mark.parametrize("kind", KINDS)
def test_trace_line_parses_and_spans_nest(runs, kind):
    record, spans = _spans(runs[kind, True][2])
    assert record["clock"] == "perf_counter" and spans
    for s in spans:
        assert s["t1"] is not None and s["t0"] <= s["t1"] and s["cpu"] >= 0
        if s["parent"] is not None:
            parent = spans[s["parent"]]
            assert parent["thread"] == s["thread"]
            assert parent["t0"] <= s["t0"] and s["t1"] <= parent["t1"]
    (main,) = [s for s in spans if s["name"] == "cli.main"]
    assert main["parent"] is None and all(main["t0"] <= s["t0"] and s["t1"] <= main["t1"] for s in spans)
    threads = {s["name"]: s["thread"] for s in spans}
    assert threads["cli.dup_scan"] != main["thread"] and threads["engine.batch"] != main["thread"]
    # a batch's spans on both threads carry its id
    waited = {s["batch"] for s in spans if s["name"] == "cli.wait"}
    assert waited and waited == {s["batch"] for s in spans if s["name"] == "engine.batch"}
    assert all(s["batch"] in waited for s in spans if s["name"].startswith("engine."))


@pytest.mark.parametrize("kind", KINDS)
def test_span_names_are_the_documented_set(runs, kind):
    _, spans = _spans(runs[kind, True][2])
    names = {s["name"] for s in spans}
    assert names <= DOCUMENTED
    assert CLI_SPANS | ENGINE_SPANS - {"engine.fallback"} <= names
    if kind == "paired":
        assert {"engine.pairing", "engine.decide"} <= names
    elif kind == "single":
        assert "engine.fallback" in names and "engine.pairing" not in names
    if kind == "ancestry":
        assert ANCESTRY_SPANS <= names
    else:  # runs without --infer-ancestors open no ancestry span
        assert not any(n.startswith("ancestry.") for n in names)


def test_ancestry_spans_nest_under_the_index_span(runs):
    """Once each, on the main thread, directly inside `cli.index`, in the
    inference's order."""
    _, spans = _spans(runs["ancestry", True][2])
    (index,) = [i for i, s in enumerate(spans) if s["name"] == "cli.index"]
    ancestry = [s for s in spans if s["name"].startswith("ancestry.")]
    assert [s["name"] for s in ancestry] == ["ancestry.source_index", "ancestry.detect", "ancestry.walk",
                                             "ancestry.emit", "ancestry.index"]
    assert all(s["parent"] == index and s["thread"] == spans[index]["thread"] for s in ancestry)
    assert all(a["t1"] <= b["t0"] for a, b in zip(ancestry, ancestry[1:]))


def test_split_counters_count_the_reads_past_the_split_size(runs):
    record, _ = _spans(runs["ancestry", True][2])
    counts = record["counts"]
    past = [n for n in LONG_LENGTHS if n > SPLIT]
    assert counts["split.reads"] == 2 * len(past)
    assert counts["split.pieces"] == 2 * sum(-(-n // SPLIT) for n in past)
    for kind in ("single", "paired"):
        assert not any(k.startswith(("split.", "ancestry.")) for k in _spans(runs[kind, True][2])[0]["counts"])


def test_ancestry_counters_count_the_duplications_and_the_widened_bases(inputs, runs):
    """`ancestry.duplications` is the detector's count; `ancestry.bases_widened`
    the positions at which the written ancestor differs from the reference."""
    record, _ = _spans(runs["ancestry", True][2])
    counts = record["counts"]
    detector = runs["ancestry", "detector"]
    assert counts["ancestry.duplications"] == len(detector.duplication_detector.get_all()) > 0

    def bases(fasta: bytes):
        return np.frombuffer(b"".join(fasta.splitlines()[1:]), dtype=np.uint8)

    reference = bases((inputs / "planted.fasta").read_bytes())
    ancestor = bases(runs["ancestry", True][0]["ancestor.fasta"])
    assert reference.shape == ancestor.shape
    assert counts["ancestry.bases_widened"] == int((reference != ancestor).sum()) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_counters_add_up(inputs, runs, kind):
    record, _ = _spans(runs[kind, True][2])
    counts = record["counts"]
    _, _, reads = _query_args(inputs, kind)
    assert counts.get("reads.single", 0) + counts.get("reads.paired", 0) == reads
    assert counts["reads." + ("single" if kind == "ancestry" else kind)] == reads
    assert 0 < counts["rows.device"] <= counts["rows.candidates"]
    assert counts["cache.hits"] >= 0 and counts["cache.skips"] >= 0
    reasons = sum(v for k, v in counts.items() if k.startswith("fallback."))
    assert reasons <= counts["reads.fallback"] <= reads
    if kind == "single":
        assert counts["reads.fallback"] >= 8 and reasons >= 8  # the unalignable reads
    assert not any(k.startswith("launches.") for k in counts)  # no kernel on the CPU


@pytest.mark.parametrize("kind", KINDS)
def test_pileup_counters_count_every_alignment(runs, kind):
    """Each component alignment is one SAM row, and the one native pass of
    `group_by_position` accumulated every one of them."""
    record, _ = _spans(runs[kind, True][2])
    sam = runs[kind, True][0]["out.sam"].decode()
    rows = [line for line in sam.splitlines() if not line.startswith("@")]
    counts = record["counts"]
    assert counts["pileup.alignments"] == counts["pileup.native"] == len(rows) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_dupscan_counters_count_the_native_rows(runs, kind):
    """The two-copy duplication scan over the index the run aligns to (with
    `--infer-ancestors`, the planted reference's inferred ancestor) grouped
    every row it gathered in its one native pass."""
    record, _ = _spans(runs[kind, True][2])
    counts = record["counts"]
    assert counts["dupscan.native_rows"] == counts["dupscan.rows"] > 0


def test_legacy_decide_line_once_per_single_end_chunk(runs):
    _, spans = _spans(runs["single", True][2])
    decides = [s for s in spans if s["name"] == "engine.decide"]
    stdout = runs["single", True][1]
    lines = [line for line in stdout.splitlines() if line.startswith(LEGACY)]
    assert decides and len(lines) == len(decides)
    assert sorted(float(line[len(LEGACY):-1]) for line in lines) == pytest.approx(
        sorted(s["t1"] - s["t0"] for s in decides), abs=6e-4)
    # the SAM on stdout: no line of the engine's among its rows
    files, sam, stderr = runs["single", "stdout"]
    assert LEGACY not in sam and "[engine]" not in sam and sam.startswith("@HD")
    assert sam.encode() == runs["single", False][0]["out.sam"]
    assert len(_trace_lines(stderr)) == 1


def test_a_run_that_fails_still_writes_its_line(monkeypatch, tmp_path):
    monkeypatch.setenv("MAPPER_TPU_TRACE", "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
        cli.main(["--queries", str(tmp_path / "none.fastq"), "--out-sam", str(tmp_path / "out.sam")])
    (record,) = _trace_lines(err.getvalue())
    assert [s[0] for s in record["spans"]] == ["cli.main"]


def test_recorder_nests_inherits_batches_and_counts_across_threads():
    rec = trace.Recorder()
    with rec.span("outer", batch=7) as outer:
        with rec.span("inner"):
            pass
        with rec.span("other", batch=8):
            pass

    def work(k):
        with rec.span("thread", batch=k):
            with rec.span("leaf"):
                rec.count("n", 1)

    threads = [threading.Thread(target=work, args=(k,), name=f"t{k}") for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    out = io.StringIO()
    rec.export(out)
    line = out.getvalue()
    assert line.startswith("[trace] {") and line.endswith("}\n") and line.count("\n") == 1
    record = json.loads(line[len("[trace] "):])
    spans = record["spans"]
    assert spans[0][:2] == ["outer", threading.current_thread().name] and spans[0][5:] == [None, 7]
    assert spans[1][0] == "inner" and spans[1][5:] == [0, 7]
    assert spans[2][0] == "other" and spans[2][5:] == [0, 8]
    assert outer.seconds == spans[0][3] - spans[0][2] >= 0
    for k in range(8):
        (top,) = [i for i, s in enumerate(spans) if s[0] == "thread" and s[6] == k]
        (leaf,) = [s for s in spans if s[0] == "leaf" and s[5] == top]
        assert leaf[1] == spans[top][1] == f"t{k}" and leaf[6] == k
    assert record["counts"] == {"n": 8}


def test_cache_hits_count_among_the_reads():
    """Queries the cache answers never reach the triage; the batch's counts
    still hold every query."""
    import torch

    from mapper_tpu_torch import Api, AlignmentParameters
    from mapper_tpu_torch.align.cache import AlignmentCache
    from mapper_tpu_torch.align.query import Query
    from mapper_tpu_torch.batch.engine import BatchAligner
    from mapper_tpu_torch.sequence import Sequence

    rng = np.random.default_rng(11)
    ref = random_reference(rng, 20_000)
    reads = simulate_reads(rng, ref, 60, 150, snp_rate=0.01, indel_fraction=0.2)
    engine = BatchAligner(Api.new_database({"chr1": ref}), AlignmentParameters.defaults(), torch.device("cpu"))
    engine.cache = AlignmentCache()
    engine.cache.choose_enable_fraction = lambda batch_size: 1.0  # store every result
    engine.tracer = trace.Recorder()
    for batch_id in (0, 1):
        engine.process_batch([Query(Sequence.from_text(n, t)) for n, t in reads], batch_id=batch_id)
    out = io.StringIO()
    engine.tracer.export(out)
    record = json.loads(out.getvalue()[len("[trace] "):])
    counts = record["counts"]
    assert counts["cache.hits"] >= 0.9 * len(reads)
    assert counts["reads.single"] == 2 * len(reads) and counts.get("reads.paired", 0) == 0
    batches = [s for s in record["spans"] if s[0] == "engine.batch"]
    assert [s[6] for s in batches] == [0, 1]
