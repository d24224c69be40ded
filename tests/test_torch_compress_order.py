"""The plain compress (``ref.compress_blocks_ref``) at an f32 compute dtype
against an f32 model of the CUDA row body ``compress_row``
(``src/repro_torch/kernels/csrc/ash_common.cuh``), bit for bit: the codes,
alpha and s.

The model below is written from the CUDA source, lane by lane: lane l of
the warp holds elements [l E, l E + E) of a row of B = 32 E; the sum of
squares is a tree inside the lane, then five xor levels across lanes
(distances 1, 2, 4, 8, 16); the rotation is ``rotate_row``'s stages (h =
1 .. E/2 inside the lane, then lane masks 1 .. 16) in f64 on the f32
products alpha g, times the f64 1/sqrt(B), rounded once to f32; every
division is an IEEE division.  numpy's float32 and float64 arithmetic
rounds each operation once, as the kernel's ``__fmul_rn`` / ``__fadd_rn``
/ ``__fdiv_rn`` and f64 adds do, and ``ml_dtypes`` casts to fp8 (round to
nearest even, as ``__nv_cvt_float_to_fp8``).

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
from repro_torch.kernels import ref

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


def kernel_model(x: torch.Tensor, cfg):
    """compress_row at an f32 compute dtype -> (q bytes (M, B) uint8, alpha
    (M,) f32, s (M, G) f32)."""
    m, b = x.shape
    e = b // 32
    fmt = cfg.format_spec
    v = x.float().numpy().reshape(m, 32, e).copy()
    # reduction 1: squares, the lane's tree, then xor levels 1 .. 16
    sq = v * v
    h = 1
    while h < e:
        for j in range(0, e, 2 * h):
            sq[:, :, j] = sq[:, :, j] + sq[:, :, j + h]
        h *= 2
    ss = sq[:, :, 0]
    o = 1
    while o < 32:
        ss = ss + ss[:, LANES ^ o]
        o *= 2
    ss = ss[:, 0]
    sigma = np.sqrt(ss / F32(b) + F32(cfg.eps))
    a = F32(cfg.tau) / sigma
    v = (a[:, None, None] * v).astype(np.float64)
    # rotate_row in f64: stages inside the lane, then across lanes
    h = 1
    while h < e:
        for j in range(e):
            if j & h == 0:
                p, r = v[:, :, j].copy(), v[:, :, j + h].copy()
                v[:, :, j], v[:, :, j + h] = p + r, p - r
        h *= 2
    mask = 1
    while mask < 32:
        other = v[:, LANES ^ mask, :]
        upper = ((LANES & mask) != 0)[None, :, None]
        v = np.where(upper, other - v, v + other)
        mask *= 2
    z = (v * (1.0 / np.sqrt(b))).astype(F32).reshape(m, b)
    # reduction 2 and the cast
    gs = cfg.quant_group_size or b
    zg = z.reshape(m, b // gs, gs)
    qmax = F32(fmt.qmax)
    s = np.maximum(np.abs(zg).max(-1) / qmax, F32(cfg.scale_eps))
    t = np.clip(zg / s[..., None], -qmax, qmax).reshape(m, b)
    if cfg.fmt == "int8":
        q = np.rint(t).astype(np.int8).view(np.uint8)
    else:
        q = t.astype(FP8[cfg.fmt]).view(np.uint8)
    return q, a, s


def bits(t) -> np.ndarray:
    """A tensor's (or array's) bits, so that -0 and +0 differ."""
    a = t.numpy() if isinstance(t, torch.Tensor) else t
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.int32)


def plain_as_bits(x, cfg):
    q, a, s = ref.compress_blocks_ref(x, cfg)
    return bits(q.view(torch.uint8)), bits(a), bits(s)


def assert_plain_is_model(x, cfg):
    got = plain_as_bits(x, cfg)
    want = [bits(w) for w in kernel_model(x, cfg)]
    apart = int((got[0] != want[0]).sum())
    assert apart == 0, f"{apart} of {got[0].size} codes differ"
    for name, g, w in zip(("alpha", "s"), got[1:], want[1:]):
        assert g.shape == w.shape and np.array_equal(g, w), name


@pytest.mark.parametrize("kind", ["planted", "tp_like"])
@pytest.mark.parametrize("gs", GROUP_SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_kernel_model_every_group_size(fmt, gs, kind, gen):
    """B = 256, every format and group size g1 .. g256."""
    assert_plain_is_model(rows_of(kind, gen, 256),
                          TacoConfig(fmt=fmt, quant_group_size=gs))


@pytest.mark.parametrize("kind", ["planted", "tp_like"])
@pytest.mark.parametrize("b", BLOCK_SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_kernel_model_every_block_size(fmt, b, kind, gen):
    """Every block size the kernels take (E = 1 .. 16 elements a lane), one
    group a row."""
    assert_plain_is_model(rows_of(kind, gen, b),
                          TacoConfig(block_size=b, fmt=fmt))


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
