"""The harness: its refusals without a card or without the program, a cell
added as files alone, and `correct` coming out false under each fault the
cells can have and under the control."""

import json
import subprocess
import sys

import pytest

from portbench import control, run
from portbench.tests.conftest import REPO, copy_bench

COMMAND = [sys.executable, "-m", "portbench.run", "--workload", "se150_gapped", "--seed", str(2**31 + 7),
           "--seconds", "1", "--trace", "0"]


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode != 0
    assert not (lines and lines[-1].startswith("{")), proc.stdout[-500:]


def test_without_a_card_the_command_prints_no_result(no_card):
    proc = subprocess.run(COMMAND, cwd=REPO, capture_output=True, text=True, timeout=300)
    _no_result(proc)
    assert "CUDA" in proc.stderr


def test_without_the_program_the_command_prints_no_result(tmp_path):
    bare = copy_bench(tmp_path / "bare")
    proc = subprocess.run(COMMAND, cwd=bare, capture_output=True, text=True, timeout=300)
    _no_result(proc)
    with pytest.raises(run.NoDevice, match="mapper_tpu_torch"):
        code = ("import sys; sys.path.remove(''); sys.path.insert(0, '.'); from pathlib import Path; "
                "from portbench import run; run.run_cell(Path('.'), 'se150_gapped', 1, 1, False, 'cpu')")
        proc = subprocess.run([sys.executable, "-c", code], cwd=bare, capture_output=True, text=True, timeout=300)
        if "NoDevice" in proc.stderr and "mapper_tpu_torch" in proc.stderr:
            raise run.NoDevice("mapper_tpu_torch")
        pytest.fail(proc.stderr[-2000:])


def test_a_new_traffic_file_and_cell_entry_run_without_edits(tiny_root):
    """A later PR's cell: a traffic file, a limits file and an entry, and no
    file of the benchmark edited."""
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*") if p.is_file()}
    (tiny_root / "portbench" / "traffic" / "snp_only.json").write_text(
        json.dumps({"name": "snp_only", "why": "1% SNPs, no indels", "snp_rate": 0.01, "indel_fraction": 0.0}))
    limits = json.loads((tiny_root / "portbench" / "cells" / "se150_gapped.json").read_text())
    (tiny_root / "portbench" / "cells" / "se150_snp.json").write_text(json.dumps(limits))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "se150_snp", "config": "ecoli_se150", "traffic": "snp_only", "chips": 1,
                               "why": "the certificate settles nearly every row"})
    for metric in bench["per_layer"]:
        metric["workloads"].append("se150_snp")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run.run_cell(tiny_root, "se150_snp", 2**31 + 5, 1, True, "cpu")
    assert result["correct"] and result["attempted"] % 3000 == 0
    assert {"cli.nonalign_s", "candidates.ms_per_kread"} <= set(result["metrics"])
    assert all(before[p] == p.read_bytes() for p in before)


def _run(root, workload="se150_gapped"):
    return run.run_cell(root, workload, 2**31 + 3, 1, False, "cpu")


@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_a_sound_run_is_correct(tiny_root, workload):
    result = _run(tiny_root, workload)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks" and set(result["metrics"]) == {"reads_per_s", "setup_s"}


@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_half_the_batch_left_out_is_not_correct(tiny_root, monkeypatch, workload):
    from mapper_tpu_torch.io.sam import SamWriter

    original = SamWriter.add_alignments
    monkeypatch.setattr(SamWriter, "add_alignments", lambda self, results: original(self, results[::2]))
    result = _run(tiny_root, workload)
    assert not result["correct"] and result["checks"]["missing_reads"]["value"] > 1000 // 2


@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(tiny_root, monkeypatch, workload):
    from mapper_tpu_torch.io.sam import SamWriter

    original = SamWriter._write_row
    done = []

    def shifted(self, alignment, flag, rnext, pnext, spacing):
        stream = self.stream

        class Shift:
            def write(self, text):
                f = text.split("\t")
                f[3] = str(int(f[3]) + 2)
                stream.write("\t".join(f))

        if getattr(self, "altered", False):  # one row of each job's SAM
            return original(self, alignment, flag, rnext, pnext, spacing)
        self.altered = True
        done.append(1)
        self.stream = Shift()
        try:
            return original(self, alignment, flag, rnext, pnext, spacing)
        finally:
            self.stream = stream

    monkeypatch.setattr(SamWriter, "_write_row", shifted)
    result = _run(tiny_root, workload)
    assert done and not result["correct"] and result["checks"]["bad_rows"]["value"] >= 1


@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_an_altered_summary_is_not_correct(tiny_root, monkeypatch, workload):
    from mapper_tpu_torch.io import mutations, vcf

    writer = mutations.MutationsWriter if workload == "se150_gapped" else vcf.VcfWriter
    original = writer._format_contig

    def altered(self, sequence, pileup):
        out = original(self, sequence, pileup)
        text = out[0] if isinstance(out, tuple) else out
        lines = text.splitlines(keepends=True)
        lines[len(lines) // 2] = lines[len(lines) // 2].replace("\t1\t", "\t2\t", 1).replace("=1+", "=2+", 1)
        text = "".join(lines)
        return (text, out[1]) if isinstance(out, tuple) else text

    monkeypatch.setattr(writer, "_format_contig", altered)
    result = _run(tiny_root, workload)
    summary = "mutation_lines_differing" if workload == "se150_gapped" else "vcf_lines_differing"
    assert not result["correct"] and result["checks"][summary]["value"] >= 1


def test_a_job_that_returns_unchanged_is_not_correct(tiny_root, monkeypatch):
    """A step that returns its state unchanged: the run succeeds and writes
    nothing."""
    from mapper_tpu_torch import cli

    monkeypatch.setattr(cli, "main", lambda argv: 0)
    result = _run(tiny_root)
    assert not result["correct"] and result["checks"]["missing_reads"]["value"] == 3000


def test_a_job_that_raises_is_not_correct(tiny_root, monkeypatch):
    from mapper_tpu_torch import cli

    original = cli.main
    calls = []

    def flaky(argv):
        calls.append(1)
        if len(calls) > 1:  # after the warm-up
            raise RuntimeError("planted")
        return original(argv)

    monkeypatch.setattr(cli, "main", flaky)
    result = _run(tiny_root)
    assert not result["correct"] and result["checks"]["failed_jobs"]["value"] == 1
    assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_the_control_is_not_correct(tiny_root, workload):
    for seed in (1, 2, 3):
        result = control.run_control(tiny_root, workload, seed, "cpu")
        gap = result["checks"]["penalty_gap"]
        assert not result["correct"] and gap["value"] > gap["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["se150_gapped", "pe150_gapped"])
def test_the_control_is_not_correct_at_the_cells_size(cuda, workload):
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        assert not control.run_control(REPO, workload, seed, cuda)["correct"]
