"""The port's entry points (`mapper_tpu_torch.graft_entry`) against the
root `__graft_entry__` (on JAX's CPU backend): the same simulated batch, the
same forward step's scores, and `dryrun_multichip` on a CPU mesh of four
entries, which never falls back to the CPU when a card is asked for."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as root_entry
from mapper_tpu_torch import graft_entry
from mapper_tpu_torch.align import banded
from mapper_tpu_torch.align.params import AlignmentParameters
from mapper_tpu_torch.parallel import mesh as mesh_lib


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulated_batch_equals_the_root_copy(seed):
    ours = graft_entry._simulated_batch(seed=seed)
    theirs = root_entry._simulated_batch(seed=seed)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_step_takes_the_int16_route():
    """The step's rows are padded to 128 wide, where the default penalties
    quantize exactly: on the card banded_i16's block kernel (band 32)."""
    params = AlignmentParameters.defaults()
    width = -(-graft_entry.LQ // banded.DEFAULT_CHUNK) * banded.DEFAULT_CHUNK
    assert banded._quantize_params(params, width, graft_entry.BAND) is not None
    assert graft_entry.BAND not in (64, 128)  # not a warp band: the block kernel


def test_entry_step_equals_the_jax_step():
    """On the CPU the step runs the int16 route's plain version; its scores
    equal the root entry's jitted float32 `_banded_scores_jnp` exactly."""
    step, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.int32 for a in args)
    assert [a.shape for a in args] == [(64, 64), (64, 96), (64,), (64,)]
    got = step(*args)
    jax_step, jax_args = root_entry.entry()
    for ours, theirs in zip(args, jax_args):
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
    want = np.asarray(jax_step(*(jnp.asarray(a.numpy()) for a in args)))
    assert got.dtype == torch.float32 and got.shape == (64,)
    assert np.array_equal(got.numpy(), want)
    assert (want < banded.BIG).all()


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_dryrun_multichip_on_a_cpu_mesh(monkeypatch, capsys):
    monkeypatch.setenv(mesh_lib.CPU_DEVICES_ENV, "4")
    graft_entry.dryrun_multichip(4)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("dryrun_multichip")]
    assert len(lines) == 1
    assert lines[0].startswith("dryrun_multichip(4): ok on cpu — scores (32,)")
    assert "mesh engine aligned 8/8" in lines[0] and "CLI --devices 4 byte-identical to 1" in lines[0]


def test_dryrun_multichip_beyond_the_visible_devices_raises(monkeypatch):
    """Unlike the root dryrun it does not fall back to more CPU entries."""
    monkeypatch.setenv(mesh_lib.CPU_DEVICES_ENV, "1")
    calls = []
    monkeypatch.setattr(graft_entry, "check_scores", lambda mesh: calls.append(mesh))
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\): only 1 devices visible"):
        graft_entry.dryrun_multichip(2)
    assert not calls


def test_dryrun_multichip_without_a_card_raises(tmp_path):
    """With no card and no CPU mesh asked for, it raises before any check."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != mesh_lib.CPU_DEVICES_ENV}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent.parent)
    proc = subprocess.run(
        [sys.executable, "-c", "from mapper_tpu_torch import graft_entry; graft_entry.dryrun_multichip(1)"],
        cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "dryrun_multichip(1): only 0 devices visible" in proc.stderr
    assert "ok on" not in proc.stdout
