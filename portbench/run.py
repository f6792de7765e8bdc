"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`): from `--seed`, the cell's reference and one sample of
reads (`generate.py`, the traffic file's rates) as FASTA/FASTQ under
`TMPDIR`; then one warm-up CLI run on the sample's first reads, which builds
the index into a `--cache-dir` under `TMPDIR`, builds or loads the port's
CUDA and native libraries and launches its kernels once.

The window (closed loop): one in-process call of
`mapper_tpu_torch.cli.main` over the whole sample is one job, one user's
run: reference load, index from the cache, duplication scan, the align
phase, the outputs written.  Jobs run back to back until their own time
adds up to `--seconds` (or the host's clock reads twice that); the job
running then is finished.  Between jobs, with the clock stopped, the
benchmark hashes the job's outputs and deletes them (the first job's stay
for the comparison) and collects Python's garbage, so that each job starts
as a fresh process would.  `reads_per_s` is the reads of all jobs over the
sum of their times: the window is the jobs' own back-to-back time, without
the benchmark's work between them.

After the window: the device's peak memory is read, the program's state is
freed, and the plain reference (`reference/`) judges the first job's
outputs; every later job must have written the same bytes.  With `--trace
1` the window runs under torch.profiler with the benchmark's spans around
the program's layers (`trace.py`), and the line holds the per-layer
metrics (`metrics/<name>.py`) in place of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import cells, generate
from portbench import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "mapper_tpu")
OUTPUT_FILES = {"sam": "out.sam", "mutations": "mutations.txt", "vcf": "out.vcf"}
ALIGN_PHASE = re.compile(r"Align phase: (\d+) queries in ([0-9.]+)s")


class NoDevice(RuntimeError):
    """The run cannot be measured here: no card, too few, or no program."""


@dataclass
class Sample:
    config: dict
    contig: str
    ref: np.ndarray  # codes
    reads: list  # generate.Reads: one, or the two mates
    files: dict  # placeholder -> path
    warm_files: dict
    num_reads: int


@dataclass
class Job:
    wall: float
    rc: int | None
    stdout: str
    stderr: str
    align_s: float | None
    cpu_s: float = 0.0  # the process's user and system time during the job
    digest: str | None = None
    error: str | None = None


@dataclass
class Window:
    jobs: list[Job] = field(default_factory=list)
    seconds: float = 0.0  # the jobs' own times, summed


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def environment(root: Path, device: str) -> None:
    """The program's defaults, its caches at fixed paths in the checkout."""
    for key in [k for k in os.environ if k.startswith("MAPPER_TPU")]:
        del os.environ[key]
    cache = root / "portbench" / ".cache"
    os.environ["MAPPER_TPU_NATIVE_CACHE"] = str(cache / "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["MAPPER_TPU_TORCH_DEVICE"] = device


def make_sample(cell, seed: int, work: Path) -> Sample:
    """The cell's reference and reads from `seed`, written under `work`."""
    cfg, traffic = cell.config, cell.traffic
    rng = np.random.default_rng(seed)
    contig = cfg["reference"]["name"]
    ref_text = generate.random_reference(rng, cfg["reference"]["length"])
    reads_cfg = cfg["reads"]
    length = reads_cfg["length"]
    generate.write_fasta(work / "ref.fasta", [contig], [ref_text], 80)
    files = {"reference": work / "ref.fasta"}
    warm = dict(files)
    n_warm = cfg["warmup_reads"]
    if reads_cfg["layout"] == "single":
        reads = [generate.simulate_reads(rng, ref_text, reads_cfg["count"], length,
                                         traffic["snp_rate"], traffic["indel_fraction"])]
        r = reads[0]
        files["reads"], warm["reads"] = work / "reads.fastq", work / "warm.fastq"
        generate.write_fastq(files["reads"], r.names, r.texts)
        generate.write_fastq(warm["reads"], r.names[:n_warm], r.texts[:n_warm])
    else:
        reads = list(generate.simulate_paired(rng, ref_text, reads_cfg["pairs"], length, reads_cfg["inner_mean"],
                                              reads_cfg["inner_sd"], traffic["snp_rate"], traffic["indel_fraction"]))
        for mate, r in enumerate(reads, start=1):
            files[f"reads_{mate}"], warm[f"reads_{mate}"] = work / f"reads_{mate}.fasta", work / f"warm_{mate}.fasta"
            generate.write_fasta(files[f"reads_{mate}"], r.names, r.texts)
            generate.write_fasta(warm[f"reads_{mate}"], r.names[: n_warm // 2], r.texts[: n_warm // 2])
    return Sample(cfg, contig, generate.encode(ref_text), reads, files, warm, sum(len(r.names) for r in reads))


def cli_argv(config: dict, files: dict, outdir: Path, cache_dir: Path) -> list[str]:
    names = {k: str(v) for k, v in files.items()}
    names.update({k: str(outdir / v) for k, v in OUTPUT_FILES.items()})
    args = [a.format(**names) for a in config["cli"]]
    return ["--reference", names["reference"], *args, "--cache-dir", str(cache_dir)]


def run_job(main, argv: list[str], spans=None) -> Job:
    out, err = io.StringIO(), io.StringIO()
    error = None
    rc = None
    cpu0 = _cpu_seconds()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    except (Exception, SystemExit):  # a job that raises fails; the run goes on to report it
        error = traceback.format_exc()
    t1 = time.perf_counter()
    cpu = _cpu_seconds() - cpu0
    if spans is not None:
        spans.add("job", t0, t1)
    m = ALIGN_PHASE.search(err.getvalue())
    return Job(t1 - t0, rc, out.getvalue(), err.getvalue(), float(m.group(2)) if m else None, cpu, error=error)


def _cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def digest(outdir: Path, outputs: list[str]) -> str:
    h = hashlib.blake2b()
    for name in outputs:
        path = outdir / OUTPUT_FILES[name]
        h.update(path.read_bytes() if path.exists() else b"<missing>")
        h.update(b"\0")
    return h.hexdigest()


def run_window(main, sample: Sample, outputs: list[str], work: Path, seconds: float, spans=None) -> Window:
    window = Window()
    t0 = time.perf_counter()
    # the jobs' own time decides; the host's clock only stops a loop of jobs
    # that return at once (a planted fault), whose own time never adds up
    while not window.jobs or (window.seconds < seconds and time.perf_counter() - t0 < 2 * seconds):
        k = len(window.jobs)
        outdir = work / f"job{k}"
        outdir.mkdir()
        gc.collect()  # each job starts without the garbage of the last, as a fresh process would
        job = run_job(main, cli_argv(sample.config, sample.files, outdir, work / "index_cache"), spans)
        window.seconds += job.wall
        job.digest = digest(outdir, outputs)
        if k > 0:
            shutil.rmtree(outdir)
        window.jobs.append(job)
        if job.error is not None or job.rc != 0:
            break
    return window


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card(chips: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of a cell; returns the result line's object.  `device`
    "cpu" runs the program's plain scorer and the reference on the host,
    for the benchmark's own tests; it measures nothing."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cells.load(root, workload)
    environment(root, device)
    import torch

    info = card(cell.chips) if device == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 0}
    try:
        from mapper_tpu_torch import cli
    except ImportError as e:
        raise NoDevice(f"the program (mapper_tpu_torch) cannot be imported here: {e}") from e
    outputs = cell.config["outputs"]
    tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
    try:
        sample = make_sample(cell, seed, tmp)
        if device == "cuda":
            torch.zeros(1, device="cuda")
        t_warm = time.perf_counter()
        (tmp / "warm").mkdir()
        warm = run_job(cli.main, cli_argv(cell.config, sample.warm_files, tmp / "warm", tmp / "index_cache"))
        if warm.error is not None or warm.rc != 0:
            raise RuntimeError(f"warm-up run failed (rc {warm.rc}):\n{warm.error or ''}{warm.stderr[-3000:]}")
        shutil.rmtree(tmp / "warm")
        gc.collect()
        setup_s = time.perf_counter() - t_start
        setup_parts = {"before_warmup_s": t_warm - t_start, "warmup_s": warm.wall, "warmup_align_s": warm.align_s}

        spans = device_trace = None
        if trace:
            spans = tr.Spans()
            tr.instrument(spans)
            os.environ["MAPPER_TPU_TRACE"] = "1"
        try:
            if trace and device == "cuda":
                trace_path = tmp / "device_trace.json"
                with tr.device_trace(trace_path) as anchors:
                    window = run_window(cli.main, sample, outputs, tmp, seconds, spans)
                device_trace = tr.read_device_trace(trace_path, anchors)
            else:
                window = run_window(cli.main, sample, outputs, tmp, seconds, spans)
        finally:
            if spans is not None:
                spans.restore()
                os.environ.pop("MAPPER_TPU_TRACE", None)
        if device == "cuda":
            info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        else:
            info["memory_peak_bytes"] = 0
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"modules loaded in the run's process that it must not load: {found}")
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        checks, failed = judge_window(sample, window, outputs, tmp / "job0", cell.limits, device)
        ref_s = time.perf_counter() - t_ref
        ok_jobs = [j for j in window.jobs if j.error is None and j.rc == 0]
        reads_per_s = sample.num_reads * len(ok_jobs) / window.seconds
        result = {
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": sample.num_reads * len(window.jobs),
            "failed": failed,
        }
        if trace:
            ctx = SimpleNamespace(jobs=window.jobs, reads_per_job=sample.num_reads, spans=spans,
                                  device=device_trace, config=cell.config)
            metrics = {}
            for m in cell.per_layer:
                value = cells.reader(root, m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = {"reads_per_s": reads_per_s, "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        result["metrics"] = metrics
        result["device"] = info
        if device_trace is not None:
            busy = sum(t1 - t0 for t0, t1 in device_trace["busy"])
            info["busy_s"] = busy
            info["window_s"] = device_trace["end"] - device_trace["start"]
            ops = sorted(device_trace["by_name"].items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(tr.idle_gaps(device_trace, spans).items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
        result["jobs"] = [{"wall_s": j.wall, "align_s": j.align_s, "cpu_s": j.cpu_s} for j in window.jobs]
        result["setup_parts"] = setup_parts
        result["reference_s"] = ref_s
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def judge_window(sample: Sample, window: Window, outputs: list[str], job0: Path, limits: dict, device: str):
    """(the numbers compared, each with its limit; reads failed)."""
    from portbench.reference import judge

    first = window.jobs[0]
    numbers = {"failed_jobs": sum(1 for j in window.jobs if j.error is not None or j.rc != 0),
               "jobs_differing": sum(1 for j in window.jobs[1:] if j.digest != first.digest)}
    texts = {}
    for name in outputs:
        path = job0 / OUTPUT_FILES[name]
        texts[name] = path.read_text() if path.exists() else ""
    best = judge.optimum(sample, device)
    numbers.update(judge.judge(sample, texts, best))
    same = 1 + sum(1 for j in window.jobs[1:] if j.digest == first.digest)
    failed = (sample.num_reads * (len(window.jobs) - same) + numbers["missing_reads"] * same
              if numbers["failed_jobs"] == 0 else sample.num_reads * len(window.jobs))
    checks = {name: {"value": value, "limit": limits["limits"][name]} for name, value in numbers.items()}
    return checks, failed


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
    root = Path.cwd()
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
