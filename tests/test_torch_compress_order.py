"""The plain compress (``ref.compress_blocks_ref``) at an f32 compute dtype
against an f32 model of the CUDA row body ``compress_segment``
(``src/repro_torch/kernels/csrc/ash_common.cuh``), bit for bit: the codes,
alpha and s; and the launch geometry of K1 and K2
(``ash_compress.geometry``), which the kernels take as it is.

The model below is written from the CUDA source, lane by lane, for a lane
width E: a warp of 32 lanes holds R = 32/L rows of B = L E elements, lane
l elements [(l % L) E, (l % L) E + E) of row l // L of its group, ragged
groups padded with zero rows; the sum of squares is a tree inside the lane,
then xor levels across lanes at distances 1 .. L/2 (inside the row's
segment); the rotation is ``rotate_segment``'s stages (h = 1 .. E/2 inside
the lane, then lane masks 1 .. L/2) in f64 on the f32 products alpha g,
times the f64 1/sqrt(B), rounded once to f32; a group's max is the lane's
(or pairwise maxima inside the lane for groups smaller than E), then xor
levels below gs/E; every division is an IEEE division.  numpy's float32 and
float64 arithmetic rounds each operation once, as the kernel's
``__fmul_rn`` / ``__fadd_rn`` / ``__fdiv_rn`` and f64 adds do, and
``ml_dtypes`` casts to fp8 (round to nearest even, as
``__nv_cvt_float2_to_fp8x2``; after the clip to +-qmax, the saturating
cast's codes).  The model runs at each B's kept E (``KEPT_E``) and at one
other E of the sweep: the stage order, not where the stages run, fixes the
bits.

Where one scale covers a lane, the kernel divides z by s without a
division (``divide_by``: one reciprocal a group, then three fma-pipe
operations an element); a model of it in exact rational arithmetic is held
to the IEEE quotient below, and the model of the row body divides.

The planted rows put one group of 8 rotated values per row at 0, so the
rotation must cancel there: a rotation in another order lands such a
value, and the group scale it sets, elsewhere, and the codes many apart.
TP-like bf16 rows (``conftest.tp_like``) are the main path's kind of data.
Every case must match exactly: there is no tolerance here.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tp_like
from test_torch_dist import one_thread  # noqa: F401  (autouse fixture)
from test_torch_gpu import planted
from repro_torch.core.registry import codec_from_spec
from repro_torch.core.taco import TacoConfig
from repro_torch.kernels import ash_compress, ref

F32 = np.float32
LANES = np.arange(32)
FORMATS = ("e4m3", "e5m2", "int8")
GROUP_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
BLOCK_SIZES = (32, 64, 128, 256, 512)
#: payload elements a case compares
ELEMS = 512 * 256
FP8 = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}


@pytest.fixture
def gen():
    return np.random.default_rng(2029)


def rows_of(kind: str, gen, b: int) -> torch.Tensor:
    rows = ELEMS // b
    if kind == "planted":
        return planted(gen, rows, b)
    return torch.from_numpy(tp_like(gen, (rows, b))).to(torch.bfloat16)


def swept_e(b: int) -> int:
    """One lane width of the sweep (8, 16, 32 elements) other than the kept
    one at block size ``b``: the farthest from it that gives 1 .. 32 lanes
    a row."""
    kept = ash_compress.KEPT_E[b]
    return max((e for e in (8, 16, 32) if e != kept and 1 <= b // e <= 32),
               key=lambda e: abs(np.log2(e / kept)))


def kernel_model(x: torch.Tensor, cfg, e: int | None = None):
    """compress_segment at an f32 compute dtype with ``e`` elements a lane
    (default the kept E) -> (q bytes (M, B) uint8, alpha (M,) f32, s (M, G)
    f32)."""
    m, b = x.shape
    e = ash_compress.KEPT_E[b] if e is None else e
    lanes = b // e                        # L
    per_warp = 32 // lanes                # R
    warps = -(-m // per_warp)
    fmt = cfg.format_spec
    rows = np.zeros((warps * per_warp, b), F32)
    rows[:m] = x.float().numpy()
    v = rows.reshape(warps, 32, e)        # (warp, lane, element)
    upper = ((LANES & np.arange(32)[:, None]) != 0)
    # reduction 1: squares, the lane's tree, then xor levels 1 .. L/2
    sq = v * v
    h = 1
    while h < e:
        for j in range(0, e, 2 * h):
            sq[..., j] = sq[..., j] + sq[..., j + h]
        h *= 2
    ss = sq[..., 0]
    o = 1
    while o < lanes:
        ss = ss + ss[:, LANES ^ o]
        o *= 2
    sigma = np.sqrt(ss * F32(1.0 / b) + F32(cfg.eps))
    a = F32(cfg.tau) / sigma              # every lane of a segment alike
    v = (a[..., None] * v).astype(np.float64)
    # rotate_segment in f64: stages inside the lane, then across lanes
    h = 1
    while h < e:
        for j in range(e):
            if j & h == 0:
                p, r = v[..., j].copy(), v[..., j + h].copy()
                v[..., j], v[..., j + h] = p + r, p - r
        h *= 2
    mask = 1
    while mask < lanes:
        other = v[:, LANES ^ mask, :]
        v = np.where(upper[mask][None, :, None], other - v, v + other)
        mask *= 2
    z = (v * (1.0 / np.sqrt(b))).astype(F32)
    # reduction 2: the group's max, one scale per element
    gs = cfg.quant_group_size or b
    qmax = F32(fmt.qmax)
    if gs >= e:
        g = np.abs(z).max(-1)
        o = 1
        while o < gs // e:
            g = np.maximum(g, g[:, LANES ^ o])
            o *= 2
        sc = np.broadcast_to(np.maximum(g / qmax, F32(cfg.scale_eps))[
            ..., None], z.shape)
    else:
        sc = np.abs(z)
        h = 1
        while h < gs:
            sc = np.maximum(sc, sc[..., np.arange(e) ^ h])
            h *= 2
        sc = np.maximum(sc / qmax, F32(cfg.scale_eps))
    t = np.clip(z / sc, -qmax, qmax).reshape(-1, b)[:m]
    if cfg.fmt == "int8":
        q = np.rint(t).astype(np.int8).view(np.uint8)
    else:
        q = t.astype(FP8[cfg.fmt]).view(np.uint8)
    alpha = a.reshape(-1, lanes)[:m, 0]
    s = np.ascontiguousarray(sc.reshape(-1, b)[:m, ::gs])
    return q, alpha, s


def bits(t) -> np.ndarray:
    """A tensor's (or array's) bits, so that -0 and +0 differ."""
    a = t.numpy() if isinstance(t, torch.Tensor) else t
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.int32)


def plain_as_bits(x, cfg):
    q, a, s = ref.compress_blocks_ref(x, cfg)
    return bits(q.view(torch.uint8)), bits(a), bits(s)


def assert_plain_is_model(x, cfg, e=None):
    got = plain_as_bits(x, cfg)
    want = [bits(w) for w in kernel_model(x, cfg, e)]
    apart = int((got[0] != want[0]).sum())
    assert apart == 0, f"{apart} of {got[0].size} codes differ"
    for name, g, w in zip(("alpha", "s"), got[1:], want[1:]):
        assert g.shape == w.shape and np.array_equal(g, w), name


@pytest.mark.parametrize("kind", ["planted", "tp_like"])
@pytest.mark.parametrize("gs", GROUP_SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_kernel_model_every_group_size(fmt, gs, kind, gen):
    """B = 256 at the kept E, every format and group size g1 .. g256."""
    assert_plain_is_model(rows_of(kind, gen, 256),
                          TacoConfig(fmt=fmt, quant_group_size=gs))


@pytest.mark.parametrize("kind", ["planted", "tp_like"])
@pytest.mark.parametrize("gs", GROUP_SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_kernel_model_swept_e_every_group_size(fmt, gs, kind,
                                                            gen):
    """B = 256 at a swept E (groups inside a lane and across lanes fall at
    other sizes), every format and group size g1 .. g256."""
    assert_plain_is_model(rows_of(kind, gen, 256),
                          TacoConfig(fmt=fmt, quant_group_size=gs),
                          swept_e(256))


@pytest.mark.parametrize("kind", ["planted", "tp_like"])
@pytest.mark.parametrize("b", BLOCK_SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_kernel_model_every_block_size(fmt, b, kind, gen):
    """Every block size the kernels take at its kept E, one group a row."""
    assert_plain_is_model(rows_of(kind, gen, b),
                          TacoConfig(block_size=b, fmt=fmt))


@pytest.mark.parametrize("kind", ["planted", "tp_like"])
@pytest.mark.parametrize("b", BLOCK_SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_kernel_model_swept_e_every_block_size(fmt, b, kind,
                                                            gen):
    """Every block size at a swept E, one group a row, on a ragged row
    count (the last row group of a warp half full)."""
    x = rows_of(kind, gen, b)
    x = x[:x.shape[0] - 32 // (b // swept_e(b)) // 2 - 1]
    assert_plain_is_model(x, TacoConfig(block_size=b, fmt=fmt), swept_e(b))


@pytest.mark.parametrize("spec", ["taco", "taco:e5m2:g8", "taco:int8:g1",
                                  "taco:b32:e5m2", "taco:b512:g16"])
def test_plain_bits_do_not_depend_on_the_row_count(spec, gen):
    """All rows at once, one row at a time and chunks of 3 give the same
    bits: a ring's chunked hop compresses as its monolithic hop does."""
    cfg = codec_from_spec(spec).cfg
    b = cfg.block_size
    x = torch.cat([rows_of("planted", gen, b)[:31],
                   rows_of("tp_like", gen, b)[:31].float()])
    whole = plain_as_bits(x, cfg)
    for step in (1, 3):
        parts = [plain_as_bits(x[i:i + step], cfg)
                 for i in range(0, x.shape[0], step)]
        for k, w in enumerate(whole):
            assert np.array_equal(np.concatenate([p[k] for p in parts]), w), \
                (step, k)


@pytest.mark.parametrize("metadata", ["", ":folded"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_form_is_the_packed_block_form(fmt, metadata, gen):
    """``compress_wire_ref`` equals ``blocks_to_wire`` of the block form
    byte for byte, as K2 equals pack(K1)."""
    cfg = codec_from_spec(f"taco:{fmt}:g8{metadata}").cfg
    slots, n = 3, 256 * 24
    x = torch.cat([rows_of("planted", gen, 256)[:36].float(),
                   rows_of("tp_like", gen, 256)[:36].float()])
    x = x.reshape(slots, n)
    q, a, s = ref.compress_blocks_ref(x.reshape(-1, 256), cfg)
    assert torch.equal(ref.compress_wire_ref(x, cfg),
                       ref.blocks_to_wire(q, a, s, cfg, slots, n))


@pytest.mark.parametrize("spec,has", [
    ("taco", True), ("taco:b32:e5m2:g1:folded", True),
    ("taco:tensorscale", False), ("taco:hadamard", False),
    ("taco:notransform", False), ("taco:cdbfloat16", False)])
def test_which_configurations_have_plain_bits(spec, has):
    """The kernels' configurations at an f32 compute dtype take the order
    above; the others (tensor scales, another transform, a bf16 compute
    dtype: no K1 path at f32) keep the rotation of ``core.ash``."""
    assert ref.plain_bits(codec_from_spec(spec).cfg) is has


# --------------------------------------------------------------------------
# K1's and K2's launch geometry (ash_compress.geometry, csrc/ash_compress.cu
# compress_rows), checked here because the kernels run only on the card
# --------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float32]


def covered(geo, rows):
    """Rows each (block, warp, lane segment) of ``geo`` takes, in the
    kernel's order: block k walks block steps k, k + grid, ..; in step t its
    warp w takes row group t W + w, rows [g R, g R + R); rows past the last
    are computed and not written."""
    warps = geo.threads // 32
    steps = -(-rows // geo.rows_per_block)
    out = []
    for blk in range(geo.grid):
        for t in range(blk, steps, geo.grid):
            g = t * warps
            for w in range(warps):
                out += [r for r in range((g + w) * geo.rows_per_warp,
                                         (g + w + 1) * geo.rows_per_warp)
                        if r < rows]
    return out


@pytest.mark.parametrize("per_sm", [None, 1, 1 << 30])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", BLOCK_SIZES)
def test_geometry_covers_every_row_once(b, dtype, per_sm):
    """Every row count from 1 to a few blocks' rows, and several grid passes
    plus a tail, is covered exactly once: by the kept geometry, by a grid of
    one block a multiprocessor and by one pass; a warp's lanes are its
    rows' lanes and the grid stays within its blocks a multiprocessor.
    KEPT_E serves many rows of bf16 input at an f32 compute dtype,
    LATENCY_E every other launch."""
    for sms in (1, 3):
        probe = ash_compress.geometry(b, dtype, 1, sms, blocks_per_sm=per_sm)
        assert probe.e == ash_compress.LATENCY_E[b]
        assert probe.lanes * probe.e == b
        assert probe.rows_per_warp * probe.lanes == 32
        assert probe.threads % 32 == 0 and probe.threads <= 256
        assert probe.rows_per_block == probe.rows_per_warp * \
            (probe.threads // 32)
        per = ash_compress.BLOCKS_PER_SM if per_sm is None else per_sm
        kept = ash_compress.geometry(b, dtype, 1, sms, e=ash_compress.KEPT_E[b])
        one_pass = sms * min(per, 64) * kept.rows_per_block
        switch = sms * kept.rows_per_block      # the first row count at
        for rows in list(range(1, 3 * probe.rows_per_block + 2)) + [
                switch - 1, switch, one_pass - 1, one_pass, one_pass + 1,
                3 * one_pass + 5]:              # KEPT_E
            geo = ash_compress.geometry(b, dtype, rows, sms,
                                        blocks_per_sm=per_sm)
            many = rows >= switch - (kept.rows_per_warp - 1)
            assert geo.e == (ash_compress.KEPT_E[b] if many and dtype ==
                             torch.bfloat16 else ash_compress.LATENCY_E[b])
            assert ash_compress.geometry(
                b, dtype, rows, sms, bf16_compute=True).e == \
                ash_compress.LATENCY_E[b]
            assert sorted(covered(geo, rows)) == list(range(rows)), \
                (rows, geo)
            assert 1 <= geo.grid <= sms * per
            assert geo.groups == -(-rows // geo.rows_per_warp)


@pytest.mark.parametrize("e", [8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", BLOCK_SIZES)
def test_lane_spans_fall_on_16_byte_words(b, dtype, e):
    """Each lane's input span (element (g 32 + lane) E, the kernel's lane
    offset) is row g R + lane // L, column (lane % L) E, starts on a 16-byte
    boundary of an aligned input and is whole 16-byte words; its payload
    span starts on a boundary of its widest store (16 bytes, 8 at E = 8).
    A geometry that would break this raises."""
    if not 1 <= b // e <= 32:
        with pytest.raises(ValueError):
            ash_compress.geometry(b, dtype, 1, 1, e=e)
        return
    geo = ash_compress.geometry(b, dtype, 100, 1, e=e)
    size = torch.empty((), dtype=dtype).element_size()
    for g in range(geo.groups):
        for lane in range(32):
            first = (g * 32 + lane) * geo.e
            row, col = divmod(first, b)
            assert col == (lane % geo.lanes) * geo.e
            assert row == g * geo.rows_per_warp + lane // geo.lanes
            assert first * size % 16 == 0 and geo.e * size % 16 == 0
            assert first % min(geo.e, 16) == 0


def test_geometry_refuses_what_no_kernel_takes():
    """bf16 at E = 4 would read 8-byte words; 64 lanes a row do not fit a
    warp: neither is built, both refused."""
    with pytest.raises(ValueError, match="16-byte"):
        ash_compress.geometry(128, torch.bfloat16, 8, 1, e=4)
    with pytest.raises(ValueError, match="elements a lane"):
        ash_compress.geometry(512, torch.float32, 8, 1, e=8)


@pytest.mark.parametrize("name,table", [("kKeptE", "KEPT_E"),
                                        ("kLatencyE", "LATENCY_E")])
def test_kept_e_is_the_kernels(name, table):
    """The wrapper's KEPT_E and LATENCY_E are the tables the library is
    built with, and each E gives whole 16-byte words of bf16 and f32 at
    its B."""
    import pathlib
    import re
    src = (pathlib.Path(ash_compress.__file__).with_name("csrc")
           / "ash_compress.cu").read_text()
    got = re.search(rf"{name}\[5\] = \{{([^}}]*)\}}", src).group(1)
    want = getattr(ash_compress, table)
    assert tuple(int(v) for v in got.split(",")) == tuple(
        want[b] for b in ash_compress.BLOCK_SIZES)
    for b in ash_compress.BLOCK_SIZES:
        for dtype in DTYPES:
            ash_compress.geometry(b, dtype, 1, 1, e=want[b])


def test_wrappers_take_the_plain_version_on_the_cpu(gen):
    """On a CPU tensor both wrappers run the plain version and launch
    nothing (the counts stay)."""
    cfg = TacoConfig(quant_group_size=32)
    x = rows_of("tp_like", gen, 256)[:24].float()
    before = (ash_compress.compress_blocks.launches,
              ash_compress.compress_wire.launches)
    got = ash_compress.compress_blocks(x, cfg)
    for g, w in zip(got, ref.compress_blocks_ref(x, cfg)):
        assert torch.equal(g, w)
    assert torch.equal(ash_compress.compress_wire(x.reshape(3, -1), cfg),
                       ref.compress_wire_ref(x.reshape(3, -1), cfg))
    assert (ash_compress.compress_blocks.launches,
            ash_compress.compress_wire.launches) == before


# --------------------------------------------------------------------------
# the one-scale division of csrc/ash_common.cuh (divide_by), in exact
# rational arithmetic: each operation rounded once to f32, as the card's
# __fmul_rn / __fmaf_rn / __frcp_rn
# --------------------------------------------------------------------------

def rn32(x) -> np.float32:
    """The rational ``x`` rounded to nearest even f32 (subnormals
    included; no overflow in these inputs)."""
    from fractions import Fraction
    x = x if isinstance(x, Fraction) else Fraction(float(x))
    if x == 0:
        return F32(0.0)
    sign, a = (-1 if x < 0 else 1), abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    e = max(e, -126) - 23                 # the ulp's exponent
    m = a / Fraction(2) ** e
    n, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and n % 2):
        n += 1
    return F32(sign * float(Fraction(n) * Fraction(2) ** e))


def fr(v):
    """An f32 (or a number) as an exact rational."""
    from fractions import Fraction
    return Fraction(float(v))


def fma32(a, b, c) -> np.float32:
    """fma(a, b, c) of three f32, rounded once, with IEEE's signed zeros
    (an exact zero sum is +0 but for -0 + -0)."""
    v = fr(a) * fr(b) + fr(c)
    if v != 0:
        return rn32(v)
    if fr(a) * fr(b) == 0 and fr(c) == 0 and \
            np.signbit(a) != np.signbit(b) and np.signbit(c):
        return F32(-0.0)
    return F32(0.0)


def divide_by(z: np.float32, s: np.float32) -> np.float32:
    y = rn32(1 / fr(s))
    q0 = z * y                            # numpy f32: rounded once
    return fma32(-fma32(s, q0, -z), y, q0)


@pytest.mark.parametrize("kind", ["tp_like", "planted", "edges"])
def test_one_scale_division_is_the_ieee_quotient(kind, gen):
    """divide_by(z, s) == RN(z / s) bit for bit wherever |z / s| >= 2^-31,
    for scales in [2^-64, 2^64] (divides_fast); below, both are under
    2^-17, the first rounding boundary of every format, with z's sign.
    On rows' rotated values and their scales at each format's qmax, and on
    quotients at powers of two, at code boundaries and at both ends of
    the scale range."""
    pairs = []
    if kind == "edges":
        for s in (F32(2.0 ** -64), F32(2.0 ** 64), F32(1.0),
                  F32(3.0 * 2.0 ** -40), F32(0.0234375), F32(2.0 ** -63)):
            for t in (448.0, 57344.0, 127.0, 1.0, 2.0 ** -17, 2.0 ** -31,
                      2.0 ** -40, 0.5, 126.5, 15.5, 1.0625, 0.0):
                for k in range(-3, 4):
                    z = rn32(fr(t) * fr(s))
                    z = np.nextafter(z, F32(np.inf)) if k > 0 else z
                    for sign in (1, -1):
                        pairs.append((F32(sign) * z * F32(1 + k * 2 ** -23),
                                      s))
    else:
        from repro_torch.core import ash
        x = rows_of(kind, gen, 256)[:6].float()
        alpha = ref.compress_blocks_ref(x, TacoConfig())[1]
        z = (ash.fwht((alpha[:, None] * x).double()) * (1.0 / np.sqrt(256))
             ).float().numpy()
        for qmax in (448.0, 57344.0, 127.0):
            for row in z:
                s = np.maximum(np.abs(row).max() / F32(qmax), F32(1e-30))
                pairs += [(v, F32(s)) for v in row]
    for z, s in pairs:
        if not 2.0 ** -64 <= s <= 2.0 ** 64:
            continue
        want = rn32(fr(z) / fr(s))
        got = divide_by(F32(z), F32(s))
        if abs(want) >= 2.0 ** -31:
            assert got.view(np.int32) == want.view(np.int32), (z, s)
        else:
            assert abs(got) < 2.0 ** -17 and abs(want) < 2.0 ** -17
            assert np.signbit(got) == np.signbit(z), (z, s)
