"""`align/kernels.py` against the CUDA source it binds, on the CPU: the
constants it mirrors, the bands whose launches take a warp kernel, the
dynamic shared memory each wrapper checks against the sum its launcher in
`csrc/banded_dp.cu` passes, and the widths that limit admits.  Reads the
source as text; needs no card."""

import re

import pytest

from mapper_tpu_torch.align import kernels

SOURCE = (kernels.CSRC / "banded_dp.cu").read_text()

# each warp kernel's lanes a thread template argument, and the band it gives
WARP_KERNELS = {
    "banded_i16": ("banded_i16_warp_kernel", 64),
    "banded_f32": ("banded_f32_warp_kernel", 32),
    "banded_roll_f32": ("banded_chunk_f32_warp_kernel", 32),
    "banded_chunk_f32": ("banded_chunk_f32_warp_kernel", 32),
}
SCORERS = ("banded_i16", "banded_f32", "banded_i16_packed", "banded_roll_f32", "banded_chunk_f32")


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, name
    return eval(m.group(1), {})


def _body(signature):
    """The text of the function whose definition starts with `signature`,
    up to its closing brace at the start of a line."""
    start = SOURCE.index(signature)
    return SOURCE[start:SOURCE.index("\n}\n", start)]


def _launcher(name):
    return _body(f'extern "C" int mapper_{name}(')


def _warp_site(launcher):
    """The text that launches the launcher's warp kernel: its own, or that
    of the float32 row kernels' shared launch."""
    if "launch_rows_f32_warp(" in launcher:
        return _body("int launch_rows_f32_warp(")
    return launcher


def _to_python(expr):
    """A C expression of the shared-memory sums as Python: casts dropped,
    sizes of the types they use, the source's constants, one ternary."""
    expr = re.sub(r"static_cast<\w+>", "", expr)
    for c_type, size in (("float", 4), ("int", 4), ("int16_t", 2)):
        expr = expr.replace(f"sizeof({c_type})", str(size))
    for const in ("kPenTable", "kCandsPerBlock", "kPairsPerBlock", "kHalf"):
        expr = expr.replace(const, str(_constant(const)))
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if m:
        expr = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
    return expr


def _smem_functions():
    found = {}
    for name, params, expr in re.findall(
        r"size_t (\w+_smem)\(([^)]*)\) \{\s*return (.*?);\s*\}", SOURCE, re.S
    ):
        args = ", ".join(p.split()[-1] for p in params.split(","))
        found[name] = eval(f"lambda {args}: {_to_python(' '.join(expr.split()))}", {})
    assert set(found) == {"block_smem", "warp_smem", "pair_smem"}
    return found


def _smem_call(text, which):
    """The one `<which>_smem(...)` call in `text`, its arguments as Python."""
    calls = re.findall(rf"\b{which}_smem\(((?:[^()]|\([^()]*\))*)\)", text)
    assert len(calls) == 1, (which, calls)
    return _to_python(calls[0])


def test_constants_match_the_source():
    assert _constant("kCandsPerBlock") == kernels._CANDS_PER_BLOCK
    assert _constant("kPairsPerBlock") == kernels._PAIRS_PER_BLOCK
    assert _constant("kPenTable") == kernels._PEN_TABLE
    assert _constant("kHalf") == kernels.PACKED_BAND
    assert _constant("kSmemOptIn") == kernels._SMEM_LIMIT
    m = re.search(r"bool warp_band\(int band\) \{ return ([^;]+); \}", SOURCE)
    assert m
    assert set(map(int, re.findall(r"band == (\d+)", m.group(1)))) == set(kernels.WARP_BANDS)


@pytest.mark.parametrize("name", sorted(WARP_KERNELS))
def test_warp_bands_match_the_dispatch(name):
    """The launcher sends WARP_BANDS, and only those, to its warp kernel, one
    instantiation per band."""
    kernel, lanes_per_arg = WARP_KERNELS[name]
    launcher = _launcher(name)
    assert "if (!warp_band(band))" in launcher
    # band == B ? kernel<P> : kernel<Q>, the one launch after the block kernels'
    picks = re.findall(
        rf"band == (\d+)\s*\?\s*{kernel}<(\d+)>\s*:\s*{kernel}<(\d+)>", _warp_site(launcher)
    )
    assert len(picks) == 1, picks
    band, p, q = map(int, picks[0])
    assert band == lanes_per_arg * p
    assert sorted((lanes_per_arg * p, lanes_per_arg * q)) == sorted(kernels.WARP_BANDS)


@pytest.mark.parametrize("name", SCORERS)
def test_smem_sums_match_the_launchers(name):
    """kernels.smem_bytes, which the wrapper checks, equals the sum the
    launcher passes, at every band and at widths and chunks on both sides of
    each other."""
    fns = _smem_functions()
    launcher = _launcher(name)
    block_site = _body("int launch(") if "return launch(" in launcher else launcher
    span = re.search(r"const int span = (.+);", launcher)
    for band in (16, 32, 64, 128, 256):
        # widths on both sides of the 48 KB default of each layout
        for lq in (1, 64, 150, 1024, 2048, 3000, 3100, 5900, 6000, 12000, 24000, 24300):
            for chunk in ((None,) if name != "banded_chunk_f32" else (1, 64, 128, 4096)):
                env = {**fns, "lq": lq, "band": band, "chunk": chunk}
                if span:
                    env["span"] = eval(_to_python(span.group(1)), env)
                if name == "banded_i16_packed":
                    if band != kernels.PACKED_BAND:
                        continue
                    want = eval(f"pair_smem({_smem_call(launcher, 'pair')})", env)
                elif band in kernels.WARP_BANDS and name in WARP_KERNELS:
                    want = eval(f"warp_smem({_smem_call(_warp_site(launcher), 'warp')})", env)
                else:
                    want = eval(f"block_smem({_smem_call(block_site, 'block')})", env)
                assert kernels.smem_bytes(name, lq, band, chunk) == want, (band, lq, chunk)


def _parent_smem(name, lq, band):
    """The shared memory each scorer but banded_chunk_f32 took before K3 and
    K5 ran one warp per pair and per candidate: K3 two block halves of
    ping-pong ints, K5 the block layout at every band, with no launch above
    48 KB."""
    if name == "banded_i16_packed":
        return 2 * 2 * 64 * 4 + 2 * (2 * lq + 64)
    if band in kernels.WARP_BANDS and name != "banded_roll_f32":
        entry = {"banded_i16": 2, "banded_f32": 4, "banded_chunk_f32": 4}[name]
        return 256 * entry + 4 * (2 * lq + band)
    return 2 * band * 4 + 2 * lq + band


@pytest.mark.parametrize("name,band", [
    (name, band) for name in SCORERS for band in (16, 32, 64, 96, 128, 256)
    if name != "banded_i16_packed" or band == kernels.PACKED_BAND
])
def test_no_width_accepted_before_is_refused(name, band):
    """Every read width the wrappers accepted at 48 KB is still accepted
    through kernels.smem_bytes and the wrapper's limit; a width past the
    limit is refused.  banded_chunk_f32's shared memory does not grow with
    the width."""
    if name == "banded_chunk_f32":
        for chunk in (1, 128, 4096):
            kernels._check_smem(kernels.smem_bytes(name, 10**6, band, chunk), 10**6)
        return
    widest = max(lq for lq in range(1, 30000) if _parent_smem(name, lq, band) <= 48 * 1024)
    for lq in (1, 150, widest // 2, widest):
        kernels._check_smem(kernels.smem_bytes(name, lq, band), lq)
    too_wide = next(lq for lq in range(widest, 10**6, 64)
                    if kernels.smem_bytes(name, lq, band) > kernels._SMEM_LIMIT)
    with pytest.raises(ValueError, match="too large"):
        kernels._check_smem(kernels.smem_bytes(name, too_wide, band), too_wide)
