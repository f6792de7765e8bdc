"""The port's host-window scorer (`mapper_tpu_torch.align.banded.banded_scores`)
against the JAX package's (`mapper_tpu.align.pallas_dp.banded_scores`) in
Pallas interpret mode, on the same numpy inputs: "pen" int16 exact with its
diagonal sums, "pen" f32 within the reference kernel test's 1e-5, band 64
exact against the reference's packed mode for odd and even batches, "roll"
and "chunk" within 1e-5, empty batches,
and the "pen" rows exactly equal to the gathered scorer on the same
candidates.  The JAX side takes the JAX package's AlignmentParameters, the
port's side the port's own, carried across by `convert`."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mapper_tpu.align import pallas_dp
from mapper_tpu.align.params import AlignmentParameters
from mapper_tpu_torch import convert
from mapper_tpu_torch.align import banded
from mapper_tpu_torch.align.params import AlignmentParameters as PortParameters
from mapper_tpu_torch.simulate import scoring_candidates

_KEYS = ("reads", "concat", "read_id", "reversed_", "win_start", "lane", "n", "m")
CHUNK = 16


def _candidates(seed, num, lq, band):
    return scoring_candidates(
        np.random.default_rng(seed), num, lq, band, ref_size=3000, num_reads=16
    )


def host_rows(seed, num, lq, band, extra=0):
    """Query rows and windows of a candidate batch (reverse complements,
    ambiguous codes, windows clamped at the reference's end), as numpy uint8.
    The windows are lq + band + `extra` wide."""
    cands = _candidates(seed, num, lq, band + extra)
    reads, concat, read_id, reversed_, win_start, _, n, _ = banded._normalize(
        *[torch.as_tensor(cands[k]) for k in _KEYS]
    )
    q, w = banded._gather_codes(reads, concat, read_id, reversed_, win_start, n, band + extra)
    return q.numpy().astype(np.uint8), w.numpy().astype(np.uint8), cands["n"], cands["m"]


def jax_scores(rows, params, band, **kwargs):
    out = pallas_dp.banded_scores(
        *rows, params, band=band, tile=8, use_pallas=True, interpret=True, chunk=CHUNK, **kwargs
    )
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _port(params):
    """The port's parameters with the JAX package's values."""
    return convert.parameters_from_reference(dataclasses.asdict(params))


def port_scores(rows, params, band, **kwargs):
    """`banded_scores` with the port's parameters of the JAX package's `params`."""
    out = banded.banded_scores(
        *[torch.as_tensor(a) for a in rows], _port(params), band=band, chunk=CHUNK, **kwargs
    )
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("band,extra", [(16, 0), (32, 8)])
def test_pen_i16_matches_pallas_interpret(band, extra):
    """Width 40 pads to 48; windows are zero-padded (extra 0) or cut."""
    rows = host_rows(band, 16, 40, band, extra)
    params = AlignmentParameters.defaults()
    assert banded._quantize_params(_port(params), 48, band) is not None
    got_s, got_d = port_scores(rows, params, band, return_diag_sums=True)
    want_s, want_d = jax_scores(rows, params, band, return_diag_sums=True)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_d, want_d)
    assert got_d.shape == (16, band) and (got_s < 1e8).any()


def test_pen_f32_matches_pallas_interpret():
    """Parameters with no exact scale <= 1024 take f32 on both sides."""
    band = 16
    rows = host_rows(3, 16, 40, band)
    params = AlignmentParameters.defaults(mutation_penalty=math.pi)
    assert banded._quantize_params(_port(params), 48, band) is None
    got_s, got_d = port_scores(rows, params, band, return_diag_sums=True)
    want_s, want_d = jax_scores(rows, params, band, return_diag_sums=True)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)
    assert (got_s < 1e8).any()


@pytest.mark.parametrize("num", [9, 12])
def test_packed_matches_pallas_and_unpacked(monkeypatch, num):
    """Band 64, int16: the port (which packs on the card whenever it can)
    gives the reference's packed run (MAPPER_TPU_PACK64=1: rows i and
    i + ceil(B / 2) share a kernel row, an odd B gets a dropped pad row) and
    its unpacked run, exactly."""
    band = 64
    rows = host_rows(num, num, 48, band)
    params = AlignmentParameters.defaults()
    got_s, got_d = port_scores(rows, params, band, return_diag_sums=True)
    monkeypatch.setenv("MAPPER_TPU_PACK64", "1")
    want_s, want_d = jax_scores(rows, params, band, return_diag_sums=True)
    monkeypatch.setenv("MAPPER_TPU_PACK64", "0")
    plain_s, plain_d = jax_scores(rows, params, band, return_diag_sums=True)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_s, plain_s)
    np.testing.assert_array_equal(got_d, plain_d)
    assert got_s.shape == (num,) and (got_s < 1e8).any()


@pytest.mark.parametrize("band,variant", [(64, "pen"), (128, "pen"), (128, "roll"), (128, "chunk")])
def test_empty_batch_returns_empty_outputs(band, variant):
    rows = (np.zeros((0, 40), np.uint8), np.zeros((0, 40 + band), np.uint8),
            np.zeros(0, np.int32), np.zeros(0, np.int32))
    out = port_scores(rows, AlignmentParameters.defaults(), band, variant=variant,
                      return_diag_sums=True)
    if variant == "pen":
        assert out[0].shape == (0,) and out[1].shape == (0, band)
    else:
        assert out.shape == (0,) and out.dtype == np.float32


@pytest.mark.parametrize("variant", ["roll", "chunk"])
def test_roll_and_chunk_match_pallas_interpret(variant):
    """Width 40 is not a multiple of the chunk (16)."""
    band = 16
    rows = host_rows(11, 16, 40, band)
    params = AlignmentParameters.defaults()
    got = port_scores(rows, params, band, variant=variant)
    want = jax_scores(rows, params, band, variant=variant)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.dtype == np.float32 and (got < 1e8).any()


@pytest.mark.parametrize("band", [16, 32])
def test_pen_rows_match_gathered_scorer(band):
    """Host rows built with `_gather_codes` through "pen" give the gathered
    scorer's scores and, at each lane, its ungapped sums, exactly."""
    lq = 64  # a multiple of CHUNK: both entries quantize at the same width
    cands = _candidates(band + 1, 40, lq, band)
    args = banded._normalize(*[torch.as_tensor(cands[k]) for k in _KEYS])
    reads, concat, read_id, reversed_, win_start, lane, n, m = args
    params = PortParameters.defaults()
    assert banded._quantize_params(params, lq, band) is not None
    gathered = banded.banded_scores_gathered(*args, params, band)
    q, w = banded._gather_codes(reads, concat, read_id, reversed_, win_start, n, band)
    scores, diag = banded.banded_scores(
        q, w, n, m, params, band=band, chunk=CHUNK, return_diag_sums=True
    )
    assert torch.equal(scores, gathered[0])
    assert torch.equal(diag[torch.arange(40), torch.clamp(lane, 0, band - 1)], gathered[1])
    assert (scores < 1e8).any()


def test_quantizer_takes_the_padded_width(monkeypatch):
    """The int16/f32 choice is made at ceil(LQ / chunk) * chunk, as the
    reference makes it: near 546 bp at default penalties the two differ."""
    widths = []
    quantize = banded._quantize_params

    def spy(params, lq, band):
        widths.append(lq)
        return quantize(params, lq, band)

    monkeypatch.setattr(banded, "_quantize_params", spy)
    params = PortParameters.defaults()
    banded.banded_scores(*host_rows(2, 4, 40, 16), params, band=16, chunk=CHUNK)
    assert widths == [48]
    assert quantize(params, 545, 16) is not None and quantize(params, 560, 16) is None


def test_banded_scores_has_no_other_device_branch():
    meta = torch.device("meta")
    q = torch.zeros((2, 16), dtype=torch.uint8, device=meta)
    w = torch.zeros((2, 48), dtype=torch.uint8, device=meta)
    n = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        banded.banded_scores(q, w, n, n, PortParameters.defaults(), band=32)
