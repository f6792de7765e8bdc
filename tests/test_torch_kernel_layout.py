"""`align/kernels.py` against the CUDA sources it binds, on the CPU: the
constants it mirrors, the bands whose launches take a warp kernel, the
dynamic shared memory each wrapper checks against the sum its launcher in
`csrc/banded_dp.cu` or `csrc/candidates.cu` passes, and the widths that
limit admits; the device-candidates program's budgets that
`csrc/candidates.cu` shares with `batch/device_candidates.py`; and the
rule that a wrapper given a CPU tensor raises.  Reads the sources as text;
needs no card."""

import re

import pytest
import torch

from mapper_tpu_torch.align import kernels
from mapper_tpu_torch.batch import device_candidates as dc
from mapper_tpu_torch.index import hashblock

# the scorers' source and the launch header it includes
SOURCE = (kernels.CSRC / "banded_dp.cu").read_text() + (kernels.CSRC / "launch.cuh").read_text()
CANDIDATES = (kernels.CSRC / "candidates.cu").read_text()

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


# ---- csrc/candidates.cu: KC1 and KC2 ----------------------------------------

# candidates.cu's constants, with the launch header's shared-memory limit
CANDIDATES_CONSTANTS = CANDIDATES + (kernels.CSRC / "launch.cuh").read_text()


def _candidates_constant(name):
    m = re.search(rf"constexpr (?:int|int64_t|uint32_t|size_t) {name} =\s*([^;]+);", CANDIDATES_CONSTANTS)
    assert m, name
    expr = " ".join(m.group(1).split()).replace("7654337u", "7654337").replace("242828353u", "242828353")
    expr = expr.replace(" / ", " // ")
    for const in set(re.findall(r"\bk[A-Z]\w*", expr)):
        expr = re.sub(rf"\b{const}\b", str(_candidates_constant(const)), expr)
    return eval(expr, {})


@pytest.mark.parametrize("name,want", [
    ("kNumLevels", dc.NUM_LEVELS), ("kVSlots", dc.V_SLOTS), ("kPSlots", dc.P_SLOTS),
    ("kMaxMatches", dc.MAX_MATCHES_PER_SEED), ("kNoKey", dc._NO_KEY),
    ("kMergeMultiplier", hashblock.MERGE_MULTIPLIER),
    ("kMergeLengthMultiplier", hashblock.MERGE_LENGTH_MULTIPLIER),
    ("kGapmerMultiplier", hashblock.GAPMER_MULTIPLIER),
    ("kGapmerInverse", hashblock._GAPMER_MULTIPLIER_INVERSE),
    ("kTeamFixedSmem", kernels._CANDIDATES_FIXED_SMEM),
    ("kHashBytes", kernels._CANDIDATES_HASH_BYTES), ("kHashSlots", 2 * dc.P_SLOTS),
    ("kRowSmemLimit", kernels._CANDIDATES_ROW_LIMIT), ("kNarrowWidth", kernels._NARROW_WIDTH),
    ("kNarrowWarps", kernels._NARROW_WARPS), ("kNarrowReads", kernels._NARROW_READS),
    ("kWideWarps", kernels._WIDE_WARPS), ("kRowsTile", kernels._ROWS_TILE),
    ("kStagedRanks", kernels._STAGED_RANKS),
])
def test_candidates_constants_match_the_module(name, want):
    """The budgets, the empty rank's key and the hash multipliers KC1 uses
    are the Python module's; its team sizes, its fixed shared memory, its
    vote table (2 x P_SLOTS slots) and the team size past which the row
    takes the scratch buffer, and KC2's tile and staged ranks, are the
    wrapper's."""
    assert _candidates_constant(name) == want


def _ternaries(expr):
    """Each `(c ? a : b)` of a C expression, innermost first, as Python."""
    while "?" in expr:
        q = expr.index("?")
        depth, start = 0, -1  # the group's opening parenthesis, or the expression's start
        for i in range(q - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(expr[i], 0)
            if depth < 0:
                start = i
                break
        depth, colon, end = 0, None, len(expr)
        for i in range(q + 1, len(expr)):
            depth += {"(": 1, ")": -1}.get(expr[i], 0)
            if depth == 0 and expr[i] == ":" and colon is None:
                colon = i
            if depth < 0:
                end = i
                break
        assert colon is not None, expr
        cond, a, b = expr[start + 1 : q], expr[q + 1 : colon], expr[colon + 1 : end]
        expr = f"{expr[:max(start, 0)]}(({a}) if ({cond}) else ({b})){expr[end + 1:]}"
    return expr


def _c_function(name):
    """A one-expression size_t or bool function of candidates.cu as Python:
    (expression, parameter names)."""
    m = re.search(rf"(?:size_t|bool) {name}\(([^)]*)\) \{{\s*return (.*?);\s*\}}", CANDIDATES, re.S)
    assert m, name
    args = ", ".join(p.split()[-1] for p in m.group(1).split(",") if p.strip())
    expr = " ".join(m.group(2).split())
    expr = re.sub(r"static_cast<\w+>", "", expr).replace("/ 16 * 16", "// 16 * 16")
    expr = expr.replace("&&", " and ").replace("||", " or ")
    expr = re.sub(r"!(?!=)", " not ", expr)
    expr = _ternaries(expr)
    for const in set(re.findall(r"\bk[A-Z]\w*", expr)):
        expr = re.sub(rf"\b{const}\b", str(_candidates_constant(const)), expr)
    return expr, args


def _c_functions():
    """candidates.cu's shared-memory sums and its narrow-team test as Python
    functions, each calling the others as the source does."""
    env = {}
    for name in ("row_bytes", "team_smem", "narrow", "candidates_smem", "rows_smem"):
        expr, args = _c_function(name)
        env[name] = eval(f"lambda {args}: {expr}", env)
    return env


def _launcher_text(name):
    start = CANDIDATES.index(f'extern "C" int mapper_{name}(')
    return CANDIDATES[start:CANDIDATES.index("\n}\n", start)]


@pytest.mark.parametrize("width", [64, 192, 448, 1024, 2048, 4992, 5056, 6016, 65536])
def test_candidates_smem_matches_the_launcher(width):
    """kernels.smem_bytes("candidates", W) is the sum mapper_candidates
    passes (a block's teams, each the fixed part and the larger of the row
    and the vote table), with the row in shared memory exactly where its
    team stays within kRowSmemLimit (candidates_in_scratch), and the scratch
    slice the wrapper allocates a block is row_bytes; smem_bytes("fused_rows")
    is mapper_fused_rows' rows_smem at every rank count, staged or not."""
    fns = _c_functions()
    launcher = _launcher_text("candidates")
    assert "candidates_smem(width, in_scratch)" in launcher
    scratch = kernels.candidates_in_scratch(width)
    assert kernels.candidates_row_bytes(width) == fns["row_bytes"](width)
    assert kernels.smem_bytes("candidates", width) == fns["candidates_smem"](width, scratch)
    assert scratch == (fns["team_smem"](width, False) > _candidates_constant("kRowSmemLimit"))
    kernels._check_smem(kernels.smem_bytes("candidates", width), width)
    assert "rows_smem(k_out)" in _launcher_text("fused_rows")
    for k_out in (1, 3, 8, 32, 33, 200):
        assert kernels.smem_bytes("fused_rows", width, k_out=k_out) == fns["rows_smem"](k_out)


@pytest.mark.parametrize("width", [64, 192, 256, 320, 1024, 5056])
def test_candidates_team_at_each_width(width):
    """kernels.candidates_team (warps a read, reads a block) is what
    mapper_candidates launches: kNarrowReads teams of kNarrowWarps warps a
    block on rows up to kNarrowWidth (the 150 bp chunk's 192, the widest
    test workload's 256), one block of kWideWarps warps a read above (the
    1,000 bp chunk's 1,024; the 5,000 bp read's 5,056 in scratch)."""
    fns = _c_functions()
    launcher = _launcher_text("candidates")
    assert "if (narrow(width, in_scratch)) {" in launcher
    assert "candidates_kernel<kNarrowWarps, kNarrowReads, false>" in launcher
    assert "(num_reads + kNarrowReads - 1) / kNarrowReads" in launcher
    assert "kNarrowWarps * 32 * kNarrowReads, smem" in launcher
    assert "candidates_kernel<kWideWarps, 1, true> : candidates_kernel<kWideWarps, 1, false>" in launcher
    narrow = fns["narrow"](width, kernels.candidates_in_scratch(width))
    want = ((_candidates_constant("kNarrowWarps"), _candidates_constant("kNarrowReads")) if narrow
            else (_candidates_constant("kWideWarps"), 1))
    assert kernels.candidates_team(width) == want
    assert narrow == (width <= 256)


def test_candidates_threshold_is_between_1000_and_5000_bp():
    """A 1,000 bp read's row (width 1,024) stays in shared memory; a
    5,000 bp read's (width 5,056) takes the scratch buffer."""
    assert not kernels.candidates_in_scratch(1024)
    assert kernels.candidates_in_scratch(5056)


@pytest.mark.parametrize("name", ["candidates", "fused_rows"])
def test_no_width_accepted_before_is_refused_by_the_candidates_kernels(name):
    """Every read width KC1 took before its teams (one block a read, its row
    in shared memory up to 4,992 and in the scratch buffer above) is still
    within the shared-memory limit; KC2 took any rank count (one block, 128
    bytes of scan slots) and still does: past kStagedRanks ranks it reads
    the rows where they lie."""
    if name == "candidates":
        for width in (1, 64, 192, 256, 320, 1024, 2560, 2624, 4992, 5056, 65536, 10**6):
            kernels._check_smem(kernels.smem_bytes(name, width), width)
        return
    for k_out in (1, 8, 32, 33, 150, 151, 1000, 10**5):
        kernels._check_smem(kernels.smem_bytes(name, 192, k_out=k_out), 192)


def _cpu_calls():
    t = torch.zeros
    u8 = t((2, 64), dtype=torch.uint8)
    i64, i32 = t(2, dtype=torch.int64), t(2, dtype=torch.int32)
    index = {**{k: t(2, dtype=torch.int64) for k in kernels._INDEX_INT64},
             **{k: t(2, dtype=torch.int32) for k in kernels._INDEX_INT32}}
    gathered = (u8, t(256, dtype=torch.uint8), i64, t(2, dtype=torch.bool), i64, i64, i32, i32)
    rows = (u8, t((2, 128), dtype=torch.uint8), i32, i32)
    return {
        "candidates": lambda: kernels.candidates(u8, i64, index, 40, 5, 2, 1000, 100, 8),
        "fused_rows": lambda: kernels.fused_rows(t((2, 17), dtype=torch.int32), i64, i64, i64, i64, 2, 1000,
                                                 100, 1024, 64, 8),
        "banded_i16": lambda: kernels.banded_i16(*gathered, (1,) * 6, 1.0, 64),
        "banded_f32": lambda: kernels.banded_f32(*gathered, (1.0,) * 6, 64),
        "banded_i16_packed": lambda: kernels.banded_i16_packed(*rows, (1,) * 6, 1.0),
        "banded_roll_f32": lambda: kernels.banded_roll_f32(*rows, (1.0,) * 6, 64),
        "banded_chunk_f32": lambda: kernels.banded_chunk_f32(*rows, (1.0,) * 6, 64, 32),
        "probe_i16": lambda: kernels.probe_i16("a", 0, t((2, 64), dtype=torch.int16), False),
    }


@pytest.mark.parametrize("name", sorted(_cpu_calls()))
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """A CUDA wrapper given CPU tensors raises before it builds or launches
    anything (the plain versions take CPU tensors one level up), and counts
    no launch."""
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cpu_calls()[name]()
    assert kernels.LAUNCHES == before
