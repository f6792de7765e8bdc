"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, and the device pileup on the card against the same on the CPU.
Skipped without one.  Imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from benchmarks.simlib import random_reference
from mapper_tpu.align.params import AlignmentParameters
from mapper_tpu.batch.candidates import ReadBatch
from mapper_tpu.pileup import MatchDatabase
from mapper_tpu.sequence import Sequence, SequenceDatabase, sort_and_complement
from mapper_tpu_torch.align import banded, kernels
from mapper_tpu_torch.batch.device_pileup import DevicePileup
from mapper_tpu_torch.probe_i16 import probes
from mapper_tpu_torch.simulate import scoring_candidates

pytestmark = pytest.mark.cuda

_KEYS = ("reads", "concat", "read_id", "reversed_", "win_start", "lane", "n", "m")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tensors(cands, device):
    return [torch.as_tensor(cands[k]).to(device) for k in _KEYS]


def _kernel_and_plain(cands, params, band, device):
    args = _tensors(cands, device)
    got = banded.banded_scores_gathered(*args, params, band)
    plain = banded._gathered_core(*banded._normalize(*args), params, band)
    torch.cuda.synchronize()
    return got.cpu().numpy(), plain.cpu().numpy()


@pytest.mark.parametrize("band", [16, 32, 64, 128])
def test_banded_i16_equals_plain(cuda, band):
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(band), 2048, 192, band)
    assert banded._quantize_params(params, 192, band) is not None
    before = kernels.LAUNCHES["banded_i16"]
    got, plain = _kernel_and_plain(cands, params, band, cuda)
    assert kernels.LAUNCHES["banded_i16"] == before + 1
    np.testing.assert_array_equal(got, plain)
    # and the CPU plain version on the same inputs
    cpu = banded.banded_scores_gathered(*_tensors(cands, torch.device("cpu")), params, band)
    np.testing.assert_array_equal(got, cpu.numpy())
    assert (got[0] < 1e8).mean() > 0.5


@pytest.mark.parametrize("band,lq,mutation", [(64, 256, np.pi), (128, 1024, 1.0)])
def test_banded_f32_matches_plain(cuda, band, lq, mutation):
    params = AlignmentParameters.defaults(mutation_penalty=mutation)
    assert banded._quantize_params(params, lq, band) is None
    cands = scoring_candidates(np.random.default_rng(lq), 512, lq, band)
    before = kernels.LAUNCHES["banded_f32"]
    got, plain = _kernel_and_plain(cands, params, band, cuda)
    assert kernels.LAUNCHES["banded_f32"] == before + 1
    # --fmad=false and the reference's operation order: equal in practice;
    # the stated tolerance is the reference kernel test's
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    assert (got[0] < 1e8).mean() > 0.5


def _host_rows(cands, band, device, chunk=128):
    """The host-window rows of a candidate batch, on `device`."""
    reads, concat, read_id, reversed_, win_start, _, n, m = banded._normalize(
        *_tensors(cands, device)
    )
    q, w = banded._gather_codes(reads, concat, read_id, reversed_, win_start, n, band)
    return banded._host_rows(q, w, n, m, band, chunk)


@pytest.mark.parametrize("band,lq", [(64, 192), (128, 192), (128, 1024)])
def test_diag_out_matches_plain(cuda, band, lq):
    """banded_i16 / banded_f32 on host rows fill every diagonal's sum (the
    1,024-wide rows take f32 at default penalties).  Called directly: at
    band 64 "pen" takes the packed kernel instead."""
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(band + lq), 256, lq, band)
    rows = _host_rows(cands, band, cuda)
    quant = banded._quantize_params(params, rows[0].shape[1], band)
    got_d = torch.empty((256, band), dtype=torch.float32, device=cuda)
    before = dict(kernels.LAUNCHES)
    if quant is None:
        name = "banded_f32"
        out = kernels.banded_f32(
            *banded._rows_as_candidates(*rows), banded._params_tuple(params), band, diag_out=got_d
        )
    else:
        name = "banded_i16"
        out = kernels.banded_i16(
            *banded._rows_as_candidates(*rows), quant[1], banded._inv(quant[0]), band,
            diag_out=got_d,
        )
    got_s = out[0]
    want_s, want_d = banded.banded_scores(
        *[r.cpu() for r in rows], params, band=band, return_diag_sums=True
    )
    torch.cuda.synchronize()
    assert name == ("banded_f32" if lq == 1024 else "banded_i16")
    assert kernels.LAUNCHES[name] == before[name] + 1
    np.testing.assert_allclose(got_s.cpu().numpy(), want_s.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_d.cpu().numpy(), want_d.numpy(), rtol=0, atol=1e-5)
    if name == "banded_i16":
        assert torch.equal(got_s.cpu(), want_s) and torch.equal(got_d.cpu(), want_d)


@pytest.mark.parametrize("num", [2047, 2048])
def test_banded_i16_packed_equals_plain(cuda, num):
    """Variant "pen" at band 64 takes the packed kernel; it equals the plain
    version and banded_i16 on the same host rows, scores and diagonal sums."""
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(num), num, 192, 64)
    rows = _host_rows(cands, 64, cuda)
    before = dict(kernels.LAUNCHES)
    got = banded.banded_scores(*rows, params, band=64, return_diag_sums=True)
    assert kernels.LAUNCHES["banded_i16_packed"] == before["banded_i16_packed"] + 1
    assert kernels.LAUNCHES["banded_i16"] == before["banded_i16"]
    plain = banded.banded_scores(*[r.cpu() for r in rows], params, band=64, return_diag_sums=True)
    scale, ints = banded._quantize_params(params, rows[0].shape[1], 64)
    diag = torch.empty((num, 64), dtype=torch.float32, device=cuda)
    out = kernels.banded_i16(
        *banded._rows_as_candidates(*rows), ints, banded._inv(scale), 64, diag_out=diag
    )
    torch.cuda.synchronize()
    for g, p, u in zip(got, plain, (out[0], diag)):
        assert torch.equal(g.cpu(), p) and torch.equal(g, u)
    assert (got[0] < 1e8).float().mean() > 0.5


@pytest.mark.parametrize("variant,name", [("roll", "banded_roll_f32"), ("chunk", "banded_chunk_f32")])
@pytest.mark.parametrize("lq,chunk", [(1024, 128), (200, 64)])
def test_roll_and_chunk_match_plain(cuda, variant, name, lq, chunk):
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(lq), 512, lq, 128)
    rows = _host_rows(cands, 128, cuda, chunk)
    before = kernels.LAUNCHES[name]
    got = banded.banded_scores(*rows, params, band=128, chunk=chunk, variant=variant)
    assert kernels.LAUNCHES[name] == before + 1
    plain = banded.banded_scores(*[r.cpu() for r in rows], params, band=128, chunk=chunk, variant=variant)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=0, atol=1e-5)
    assert (got < 1e8).float().mean() > 0.5


def test_chunk_kernel_takes_a_ragged_last_chunk(cuda):
    """Width 200 in chunks of 64: the last chunk is cut short."""
    params6 = banded._params_tuple(AlignmentParameters.defaults())
    cands = scoring_candidates(np.random.default_rng(200), 512, 200, 128)
    q, w, n, m = _host_rows(cands, 128, cuda, chunk=8)
    assert q.shape[1] == 200
    got = kernels.banded_chunk_f32(q, w, n, m, params6, 128, 64)
    want = kernels.banded_roll_f32(q, w, n, m, params6, 128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_host_row_wrappers_skip_an_empty_batch(cuda):
    q = torch.zeros((0, 128), dtype=torch.uint8, device=cuda)
    w = torch.zeros((0, 256), dtype=torch.uint8, device=cuda)
    n = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = dict(kernels.LAUNCHES)
    params6 = banded._params_tuple(AlignmentParameters.defaults())
    assert kernels.banded_roll_f32(q, w, n, n, params6, 128).shape == (0,)
    assert kernels.banded_chunk_f32(q, w, n, n, params6, 128, 128).shape == (0,)
    scores, diag = kernels.banded_i16_packed(q, w, n, n, (30, 1, 63, 18, 60, 15), 1 / 30)
    assert scores.shape == (0,) and diag.shape == (0, 64)
    params = AlignmentParameters.defaults()
    for band in (64, 128):
        scores, diag = banded.banded_scores(q, w, n, n, params, band=band, return_diag_sums=True)
        assert scores.shape == (0,) and diag.shape == (0, band)
    assert kernels.LAUNCHES == before


def test_wrapper_rejects_bad_inputs(cuda):
    cands = scoring_candidates(np.random.default_rng(3), 64, 64, 32)
    args = banded._normalize(*_tensors(cands, cuda))
    bad = list(args)
    bad[4] = bad[4].to(torch.int32)  # win_start must be int64
    with pytest.raises(ValueError):
        kernels.banded_f32(*bad, banded._params_tuple(AlignmentParameters.defaults()), 32)
    with pytest.raises(ValueError):
        kernels.banded_f32(*[a.cpu() for a in args], (1.0,) * 6, 32)


@pytest.mark.parametrize(
    "stage,body", [(stage, body) for stage, bodies in probes.STAGES.items() for body in bodies]
)
def test_probe_body_equals_plain(cuda, stage, body):
    """Each probe body's kernel equals its plain version exactly: on the
    probes' own input, over the whole int16 range (adds wrap), and on a
    block of another width."""
    rng = np.random.default_rng(sum(map(ord, stage + body)))
    blocks = [
        probes.probe_input(cuda),
        torch.from_numpy(rng.integers(-2**15, 2**15, (probes.T, probes.B)).astype(np.int16)).to(cuda),
        torch.from_numpy(rng.integers(-2**15, 2**15, (7, 200)).astype(np.int16)).to(cuda),
    ]
    for x in blocks:
        before = kernels.LAUNCHES[f"probe_i16_{stage}"]
        got = probes.run(stage, body, x)
        assert kernels.LAUNCHES[f"probe_i16_{stage}"] == before + 1
        want = probes.plain(stage, body, x)
        torch.cuda.synchronize()
        assert got.dtype == torch.int16 and got.shape == want.shape
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), probes.plain(stage, body, x.cpu()))


def test_device_pileup_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(11)
    contigs = sort_and_complement(
        [Sequence.from_text("c1", random_reference(rng, 5000)),
         Sequence.from_text("c2", random_reference(rng, 3000))]
    )
    seq_db = SequenceDatabase(contigs)
    reads, rid, rev, gstart, n = [], [], [], [], []
    for i in range(4000):  # many rows per position: the atomic adds collide
        k = int(rng.integers(0, 2)) * 2  # forward contigs sit at even indices here
        assert contigs[k].complemented_from is None
        length = int(rng.integers(60, 150))
        off = int(rng.integers(0, len(contigs[k]) - length))
        reads.append(Sequence.from_text(f"r{i}", contigs[k].get_range(off, length)))
        rid.append(i)
        rev.append(bool(rng.random() < 0.5))
        gstart.append(int(seq_db.starts[k]) + off)
        n.append(length)
    args = (ReadBatch.from_sequences(reads), np.array(rid), np.array(rev), np.array(gstart),
            np.array(n), np.ones(len(rid), dtype=np.float32))
    merged = []
    for device in (cuda, torch.device("cpu")):
        pileup = DevicePileup(seq_db, 0.1, device)
        pileup.add_rows(*args)
        db = MatchDatabase(0.1)
        pileup.merge_into(db)
        merged.append({s.name: p for s, p in db.group_by_position().items()})
    assert set(merged[0]) == set(merged[1]) == {"c1", "c2"}
    for name, p in merged[0].items():
        np.testing.assert_array_equal(p.middle, merged[1][name].middle)
        np.testing.assert_array_equal(p.end, merged[1][name].end)
