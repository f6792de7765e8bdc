"""The plain versions of the int16 probe kernels (`mapper_tpu_torch.probe_i16`)
against the JAX probe bodies of `benchmarks/probe_i16`, run through
`pl.pallas_call(..., interpret=True)` with each probe's own BlockSpecs:
exactly equal, on the probes' own input, on a seeded input over the DP's
domain [0, 16384], and on one over the whole int16 range, where adds wrap.

The JAX stages run their probes when they are loaded; the fixture loads each
one with `pl.pallas_call` wrapped to run in interpret mode and to record
each body's kernel and call arguments, in order.  Each stage's source puts a
fixed directory at the front of `sys.path`; the fixture runs the source with
that line taken out, so that no later import in the worker resolves outside
this checkout."""

import contextlib
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mapper_tpu_torch.probe_i16 import probes

PROBE_DIR = Path(__file__).resolve().parent.parent / "benchmarks" / "probe_i16"
BODIES = [(stage, body) for stage, bodies in probes.STAGES.items() for body in bodies]


def _run_stage(stage):
    """Run a JAX stage's source as `__main__`, with its `sys.path.insert`
    line blanked (line numbers kept)."""
    path = PROBE_DIR / f"{stage}.py"
    source = re.sub(r"^sys\.path\.insert\(.*\)$", "", path.read_text(), flags=re.M)
    assert "sys.path" not in source, path
    exec(compile(source, str(path), "exec"), {"__name__": "__main__", "__file__": str(path)})


@pytest.fixture(scope="module")
def jax_bodies():
    """(stage, body) -> (pallas_call with the probe's arguments in interpret
    mode, its output on the probe's own input)."""
    real = pl.pallas_call
    recorded = {}
    saved_path = list(sys.path)
    try:
        for stage in probes.STAGES:
            calls = []

            def recording(kernel, **kwargs):
                call = real(kernel, interpret=True, **kwargs)

                def launch(x):
                    out = call(x)
                    calls.append((call, np.asarray(out)))
                    return out

                return launch

            pl.pallas_call = recording
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                _run_stage(stage)
            names = re.findall(r"^(\S+): OK", printed.getvalue(), flags=re.M)
            assert tuple(names) == probes.STAGES[stage], printed.getvalue()
            recorded.update({(stage, name): call for name, call in zip(names, calls)})
        path_after = list(sys.path)
    finally:
        pl.pallas_call = real
        sys.path[:] = saved_path
    assert path_after == saved_path
    return recorded


def test_the_table_covers_every_probe_site():
    assert len(BODIES) == 40
    for stage, site in probes.SITES.items():
        path, line = site.rsplit(":", 1)
        text = (PROBE_DIR.parent.parent / path).read_text().splitlines()
        assert "pl.pallas_call(" in text[int(line) - 1], site


@pytest.mark.parametrize("inputs", ["probe_input", "seeded", "full_range"])
@pytest.mark.parametrize("stage,body", BODIES)
def test_plain_equals_jax_body(jax_bodies, stage, body, inputs):
    call, on_probe_input = jax_bodies[(stage, body)]
    if inputs == "probe_input":
        x = probes.probe_input().numpy()
        want = on_probe_input
    else:
        low, high = (0, probes.INF16 + 1) if inputs == "seeded" else (-2**15, 2**15)
        rng = np.random.default_rng(sum(map(ord, stage + body + inputs)))
        x = rng.integers(low, high, size=(probes.T, probes.B)).astype(np.int16)
        want = np.asarray(call(x))
    got = probes.run(stage, body, torch.from_numpy(x))
    assert got.dtype == torch.int16
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    check = probes.NUMPY_CHECKS.get((stage, body))
    if check is not None and inputs == "probe_input":
        np.testing.assert_array_equal(got.numpy(), check(x))


def test_run_takes_any_block_and_refuses_other_devices():
    x = torch.from_numpy(np.random.default_rng(5).integers(-2**15, 2**15, (3, 200)).astype(np.int16))
    assert tuple(probes.run("g", "step", x).shape) == (3, 200)
    assert tuple(probes.run("g", "reduce", x).shape) == (3, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.run("g", "step", x.to("meta"))
    with pytest.raises(ValueError, match="int16"):
        probes.run("g", "step", x.to(torch.int32))
