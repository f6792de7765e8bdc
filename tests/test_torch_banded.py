"""The port's plain banded-DP scorer (`mapper_tpu_torch.align.banded`)
against the JAX package's (`mapper_tpu.align.pallas_dp`), on the same numpy
inputs: the f32 reference scorer, the gathered scorer in Pallas interpret
mode (int16 exact, f32 within the reference kernel test's 1e-5), the
fixed-point quantizer and int16 saturation.  Each side takes its own
package's AlignmentParameters: the port's are carried across from the JAX
package's fields (`convert.parameters_from_reference`)."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from mapper_tpu import basepairs
from mapper_tpu.align import pallas_dp
from mapper_tpu.align.dp import _forward_dp
from mapper_tpu.align.params import AlignmentParameters
from mapper_tpu_torch import convert
from mapper_tpu_torch.align import banded
from mapper_tpu_torch.simulate import scoring_candidates

_KEYS = ("reads", "concat", "read_id", "reversed_", "win_start", "lane", "n", "m")


def _port(params):
    """The port's parameters with the JAX package's values."""
    return convert.parameters_from_reference(dataclasses.asdict(params))


def random_pair(rng, n, shift, num_snps=0, indel=0):
    ref = rng.integers(0, 4, size=n + 2 * shift)
    ref_codes = np.array([1, 2, 4, 8], dtype=np.uint8)[ref]
    q = list(ref_codes[shift : shift + n])
    for _ in range(num_snps):
        pos = int(rng.integers(0, len(q)))
        q[pos] = int(np.array([1, 2, 4, 8])[rng.integers(0, 4)])
    if indel > 0:
        pos = int(rng.integers(5, len(q) - 5))
        if rng.random() < 0.5:
            for _ in range(indel):
                q.insert(pos, int(np.array([1, 2, 4, 8])[rng.integers(0, 4)]))
            q = q[:n]
        else:
            del q[pos : pos + indel]
    return np.array(q, dtype=np.uint8), ref_codes


def pair_batch(rng, count, lq, shift, band, snps=(0, 3), indels=(0, 2)):
    batch_q, batch_w, ns, ms = [], [], [], []
    for _ in range(count):
        n = int(rng.integers(lq // 2, lq))
        q, w = random_pair(
            rng, n, shift, num_snps=int(rng.integers(*snps)), indel=int(rng.integers(*indels))
        )
        batch_q.append(np.pad(q, (0, lq - q.shape[0])))
        batch_w.append(np.pad(w, (0, lq + band - w.shape[0])))
        ns.append(q.shape[0])
        ms.append(w.shape[0])
    return np.stack(batch_q), np.stack(batch_w), np.array(ns), np.array(ms)


def host_exact_score(q, w, params):
    best, _, _ = _forward_dp(q, w, params, may_extend=False, max_ins_ext=0.0)
    return float(best[q.shape[0]].min())


@pytest.mark.parametrize("seed", range(6))
def test_reference_matches_jax_reference_and_host_dp(seed):
    rng = np.random.default_rng(seed)
    params = AlignmentParameters.defaults(max_error_rate=1.0)
    lq, shift, band = 48, 8, 32
    q, w, n, m = pair_batch(rng, 8, lq, shift, band)
    got = banded.banded_scores_reference(q, w, n, m, _port(params), band).numpy()
    want = np.asarray(pallas_dp.banded_scores_reference(q, w, n, m, params, band))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for i in range(8):
        exact = host_exact_score(q[i, : n[i]], w[i, : m[i]], params)
        assert got[i] == pytest.approx(exact, abs=1e-4), f"case {i}"


def test_reference_matches_pallas_interpret():
    rng = np.random.default_rng(42)
    params = AlignmentParameters.defaults(max_error_rate=1.0)
    lq, shift, band = 32, 4, 16
    q, w, n, m = pair_batch(rng, 8, lq, shift, band, snps=(1, 2), indels=(1, 2))
    pallas = np.asarray(
        pallas_dp.banded_scores(
            q, w, n, m, params, band=band, tile=4, use_pallas=True, interpret=True, chunk=16
        )
    )
    got = banded.banded_scores_reference(q, w, n, m, _port(params), band).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("num_snps,allowed", [(0, (0.0,)), (1, (0.0, 1.0))])
def test_perfect_and_snp_scores(num_snps, allowed):
    params = AlignmentParameters.defaults(max_error_rate=1.0)
    q, w = random_pair(np.random.default_rng(7 + num_snps), 40, 8, num_snps=num_snps)
    got = banded.banded_scores_reference(q[None], w[None], [40], [w.shape[0]], _port(params), 32)
    want = pallas_dp.banded_scores_reference(q[None], w[None], [40], [w.shape[0]], params, 32)
    assert float(got[0]) == float(np.asarray(want)[0])
    assert any(float(got[0]) == pytest.approx(a, abs=1e-6) for a in allowed)


def _port_gathered(cands, params, band):
    args = [torch.as_tensor(cands[k]) for k in _KEYS]
    return banded.banded_scores_gathered(*args, _port(params), band).numpy()


def _port_gathered_f32(cands, params, band):
    """The port's f32 path composed by hand (its entry point picks int16 for
    these parameters, as the JAX one does without MAPPER_TPU_NO_INT16)."""
    reads, concat, read_id, reversed_, win_start, lane, n, m = banded._normalize(
        *[torch.as_tensor(cands[k]) for k in _KEYS]
    )
    q, w = banded._gather_codes(reads, concat, read_id, reversed_, win_start, n, band)
    scores, diag = banded._pen_core(q, w, n, m, banded._params_tuple(_port(params)), band)
    ung = diag[torch.arange(read_id.shape[0]), torch.clamp(lane, 0, band - 1)]
    return torch.stack([scores, ung]).numpy()


def _jax_gathered(cands, params, band):
    banded_s, ung = pallas_dp.banded_scores_gathered(
        cands["reads"], jax.device_put(cands["concat"]), cands["read_id"],
        cands["reversed_"], cands["win_start"], cands["lane"], cands["n"], cands["m"],
        params, band=band, tile=8, interpret=True, read_bucket=8, use_pallas=True,
    )
    return np.stack([np.asarray(banded_s), np.asarray(ung)])


@pytest.mark.parametrize("band", [16, 32, 64])
@pytest.mark.parametrize("path", ["i16", "f32"])
def test_gathered_matches_pallas_interpret(monkeypatch, band, path):
    """Reverse-complemented rows, windows clamped at the reference's end,
    lanes outside the band."""
    lq = 128 if band < 64 else 96
    cands = scoring_candidates(
        np.random.default_rng(band), 40, lq, band, ref_size=3000, num_reads=16
    )
    assert cands["reversed_"].any() and (cands["lane"] < 0).any() and (cands["lane"] >= band).any()
    assert (cands["win_start"] + lq + band > cands["concat"].shape[0]).any()
    params = AlignmentParameters.defaults()
    assert pallas_dp._quantize_params(params, lq, band) is not None
    if path == "i16":
        got = _port_gathered(cands, params, band)
        want = _jax_gathered(cands, params, band)
        np.testing.assert_array_equal(got, want)
    else:
        monkeypatch.setenv("MAPPER_TPU_NO_INT16", "1")
        got = _port_gathered_f32(cands, params, band)
        want = _jax_gathered(cands, params, band)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[0] < 1e8).any()


def test_gathered_f32_by_quantizer_matches_pallas_interpret():
    """Parameters with no exact scale take the f32 path on both sides."""
    band, lq = 32, 64
    params = AlignmentParameters.defaults(mutation_penalty=math.pi)
    assert banded._quantize_params(_port(params), lq, band) is None
    cands = scoring_candidates(np.random.default_rng(5), 32, lq, band, ref_size=2000, num_reads=12)
    np.testing.assert_allclose(
        _port_gathered(cands, params, band), _jax_gathered(cands, params, band), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize(
    "kwargs,lq,band",
    [
        ({}, 192, 64),
        ({}, 2048, 64),
        ({}, 512, 128),
        ({}, 576, 128),
        ({"mutation_penalty": math.pi}, 192, 64),
        ({"max_error_rate": 1.0}, 64, 32),
        ({"max_error_rate": 1.0}, 2048, 16),
        ({"indel_start_penalty": 2.0, "indel_extension_penalty": 0.25}, 256, 128),
    ],
)
def test_quantize_params_matches_jax(kwargs, lq, band):
    params = AlignmentParameters.defaults(**kwargs)
    assert banded._quantize_params(_port(params), lq, band) == pallas_dp._quantize_params(
        params, lq, band
    )
    assert banded._params_tuple(_port(params)) == pallas_dp._params_tuple(params)


def test_int16_saturation_reports_big():
    params = AlignmentParameters.defaults(max_error_rate=1.0)
    band, lq = 16, 64
    assert banded._quantize_params(_port(params), 2048, band) is None
    reads = torch.full((1, lq), 1, dtype=torch.uint8)  # all A
    concat = torch.full((lq + band,), 2, dtype=torch.uint8)  # all C
    zero = torch.zeros(1, dtype=torch.int64)
    out = banded.banded_scores_gathered(
        reads, concat, zero, torch.zeros(1, dtype=torch.bool), zero, zero,
        torch.tensor([lq]), torch.tensor([lq + band]), _port(params), band,
    )
    want = np.asarray(
        pallas_dp.banded_scores(
            reads.numpy(), concat.numpy()[None], np.array([lq]), np.array([lq + band]),
            params, band=band, tile=8, use_pallas=True, interpret=True,
        )
    )
    assert float(out[0, 0]) == 64.0 == float(want[0])
    # a saturated row comes back as BIG, never as a wrapped small value
    scores_i, _ = banded._pen_core_i16(
        reads.to(torch.int32), concat[None].to(torch.int32), torch.tensor([lq], dtype=torch.int32),
        torch.tensor([lq + band], dtype=torch.int32), (400, 1, 840, 240, 800, 200), band,
    )
    assert int(scores_i[0]) == banded.INF16


def test_reverse_complement_gather_matches_basepairs():
    cands = scoring_candidates(np.random.default_rng(1), 16, 64, 32, ref_size=1000, num_reads=8)
    reads, concat, read_id, reversed_, win_start, _, n, _ = banded._normalize(
        *[torch.as_tensor(cands[k]) for k in _KEYS]
    )
    q, w = banded._gather_codes(reads, concat, read_id, reversed_, win_start, n, 32)
    for c in range(16):
        row = cands["reads"][cands["read_id"][c], : cands["n"][c]]
        want = basepairs.reverse_complement(row) if cands["reversed_"][c] else row
        assert q[c, : cands["n"][c]].numpy().tolist() == want.tolist()
        idx = np.minimum(cands["win_start"][c] + np.arange(96), 999)
        assert w[c].numpy().tolist() == cands["concat"][idx].tolist()
