"""K7, the butterfly compress (``repro_torch.kernels.fwht_butterfly``): its
plain version against the JAX package's Pallas kernel
``compress_blocks_butterfly`` in interpret mode, on the shapes and formats
of ``tests/test_fwht_kernel.py``.  Inputs come from generators of this
module's own, seeded per test.

Tolerances: alpha within rtol 1e-5 and s within rtol 1e-4 (those of
``tests/test_fwht_kernel.py``); the payload under the parity rule of
``repro_torch.kernels.ref`` (at most 1e-4 of the bytes differ, each by
one code — so these small comparisons must match exactly).  Both sides
run the same butterfly in the same stage order; only the mean of squares
is summed in another order.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core.taco import TacoConfig as JConfig
from repro.kernels.ash_compress import compress_blocks_pallas
from repro.kernels.fwht_butterfly import compress_blocks_butterfly as jk7
from repro_torch.core.taco import TacoConfig
from repro_torch.kernels import fwht_butterfly, ref

SHAPES = [(4, 256), (130, 256), (16, 64), (7, 512),
          # every power-of-two width of the JAX kernel's sweep
          (33, 32), (9, 128)]


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def wire(q, alpha, s, cfg):
    """Block-level arrays -> one dual wire row, for the parity rule."""
    m, b = q.shape
    return ref.blocks_to_wire(q, alpha, s, cfg, 1, m * b)


@pytest.mark.parametrize("fmt", ["e4m3", "int8"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_the_interpret_kernel(shape, fmt, rng):
    m, b = shape
    x = tp_like(rng, shape)
    cfg = TacoConfig(block_size=b, fmt=fmt)
    qj, aj, sj = jk7(jnp.asarray(x), JConfig(block_size=b, fmt=fmt,
                                              impl="pallas_interpret"),
                     interpret=True)
    q, a, s = fwht_butterfly.compress_blocks_butterfly(torch.from_numpy(x),
                                                       cfg)
    assert q.dtype == cfg.format_spec.dtype and s.shape == (m, 1)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-4)
    want = wire(torch.from_numpy(np.array(qj).view(np.uint8)).view(q.dtype),
                torch.from_numpy(np.array(aj)), torch.from_numpy(np.array(sj)),
                cfg)
    ref.check_wire_parity(wire(q, a, s, cfg), want, m * b, cfg)


@pytest.mark.parametrize("fmt", ["e4m3", "int8"])
def test_block_scale_matches_k1(fmt, rng):
    """K7 computes K1's function with its one block scale: the same scales
    and alpha as the matmul form, and its codes within one-code rounding
    boundaries of K1's (the rotations sum in different orders)."""
    x = torch.from_numpy(tp_like(rng, (64, 256)))
    cfg = TacoConfig(fmt=fmt)
    q, a, s = fwht_butterfly.compress_blocks_butterfly(x, cfg)
    qm, am, sm = ref.compress_blocks_ref(x, cfg)
    torch.testing.assert_close(a, am, rtol=1e-5, atol=0)
    torch.testing.assert_close(s, sm, rtol=1e-4, atol=0)
    ref.check_wire_parity(wire(q, a, s, cfg), wire(qm, am, sm, cfg),
                          x.numel(), cfg)


def test_scale_floor_is_the_references_fixed_floor():
    """An all-zero block takes s = 1e-30, the kernel's fixed floor, not
    ``cfg.scale_eps``: the reference ignores the config's floor."""
    x = np.zeros((2, 256), np.float32)
    cfg = TacoConfig(scale_eps=1e-20)
    _, _, s = fwht_butterfly.compress_blocks_butterfly(torch.from_numpy(x),
                                                       cfg)
    _, _, sj = jk7(jnp.asarray(x), JConfig(scale_eps=1e-20,
                                            impl="pallas_interpret"),
                   interpret=True)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert float(s[0, 0]) == float(np.float32(ref.BUTTERFLY_SCALE_FLOOR))


def test_wrapper_takes_the_plain_version_only_on_the_cpu(monkeypatch, rng):
    x = torch.from_numpy(tp_like(rng, (3, 64)))
    cfg = TacoConfig(block_size=64)
    before = fwht_butterfly.compress_blocks_butterfly.launches
    for got, want in zip(fwht_butterfly.compress_blocks_butterfly(x, cfg),
                         ref.compress_blocks_butterfly_ref(x, cfg)):
        assert torch.equal(got, want)
    assert fwht_butterfly.compress_blocks_butterfly.launches == before

    def boom(*a, **k):
        raise AssertionError("plain version called off the CPU")
    monkeypatch.setattr(ref, "compress_blocks_butterfly_ref", boom)
    with pytest.raises(ValueError, match="no kernel"):
        fwht_butterfly.compress_blocks_butterfly(
            torch.zeros(1, 256, device="meta"), cfg)


def test_matmul_form_agrees_as_in_the_reference(rng):
    """The JAX test's own cross-check, on the port: K7's plain version and
    the interpret-mode matmul kernel K1 share alpha and block scales."""
    x = tp_like(rng, (130, 256))
    _, _, sm = compress_blocks_pallas(jnp.asarray(x), JConfig(
        impl="pallas_interpret"), interpret=True)
    _, _, s = fwht_butterfly.compress_blocks_butterfly(torch.from_numpy(x),
                                                       TacoConfig())
    np.testing.assert_allclose(s.numpy(), np.asarray(sm), rtol=1e-4)


@pytest.mark.parametrize("b", [32, 64, 128, 256, 512])
def test_flops_per_element_are_the_references(b):
    """The two rotation forms' structural counts, as the JAX package's."""
    from repro.kernels.fwht_butterfly import flops_per_element as jflops
    assert fwht_butterfly.flops_per_element(b) == jflops(b)


def test_kernel_widths_are_every_power_of_two_of_the_sweep():
    """K7 takes the widths K1 to K6 take (B = 32 .. 512), as the TPU
    kernel takes every power of two."""
    from repro_torch.kernels import ash_compress
    assert fwht_butterfly.BLOCK_SIZES == tuple(2 ** k for k in range(5, 10))
    assert set(fwht_butterfly.BLOCK_SIZES) <= set(ash_compress.BLOCK_SIZES)


# --------------------------------------------------------------------------
# the kernel's launch geometry and lane split (csrc/fwht_butterfly.cu),
# checked here because the kernel itself runs only on the card
# --------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float32]


def _covered(geo, rows):
    """Rows each (block, warp, lane segment) of ``geo`` takes, in the
    kernel's order: warp w of block k walks groups w + k W, + grid W, ...;
    group g is rows [g R, g R + R), and its ragged rows are masked."""
    warps = geo.threads // 32
    out = []
    for blk in range(geo.grid):
        for w in range(warps):
            g = blk * warps + w
            while g < geo.groups:
                out += [r for r in range(g * geo.rows_per_warp,
                                         (g + 1) * geo.rows_per_warp)
                        if r < rows]
                g += geo.grid * warps
    return out


@pytest.mark.parametrize("per_sm", [None, 1, 1 << 30])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", fwht_butterfly.BLOCK_SIZES)
def test_geometry_covers_every_row_once(b, dtype, per_sm):
    """Every row count from 1 to a few blocks' rows is covered exactly
    once, by the kept geometry, by a grid of one block a multiprocessor
    (several passes) and by one pass; a warp's lanes are its rows' lanes."""
    for sms in (1, 3):
        probe = fwht_butterfly.geometry(b, dtype, 1, sms,
                                        blocks_per_sm=per_sm)
        assert probe.lanes * probe.e == b
        assert probe.rows_per_warp * probe.lanes == 32
        assert probe.rows_per_block == probe.rows_per_warp * \
            (probe.threads // 32)
        for rows in list(range(1, 3 * probe.rows_per_block + 2)) + \
                [sms * 9 * probe.rows_per_block + 5]:
            geo = fwht_butterfly.geometry(b, dtype, rows, sms,
                                          blocks_per_sm=per_sm)
            got = _covered(geo, rows)
            assert sorted(got) == list(range(rows)), (rows, geo)
            assert geo.grid <= sms * (fwht_butterfly.BLOCKS_PER_SM
                                      if per_sm is None else per_sm)


@pytest.mark.parametrize("e", [8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", fwht_butterfly.BLOCK_SIZES)
def test_lane_spans_are_whole_16_byte_words(b, dtype, e):
    """Each lane's input span starts on a 16-byte boundary (the wrapper
    takes 16-byte aligned rows) and is whole 16-byte words; its code span
    starts on a boundary of its own store width (8 bytes at E = 8, else
    16).  A geometry that would break this raises."""
    if not 1 <= b // e <= 32:
        with pytest.raises(ValueError):
            fwht_butterfly.geometry(b, dtype, 1, 1, e=e)
        return
    geo = fwht_butterfly.geometry(b, dtype, 100, 1, e=e)
    size = torch.empty((), dtype=dtype).element_size()
    for g in range(geo.groups):
        for lane in range(32):
            first = (g * 32 + lane) * geo.e   # the kernel's lane offset
            row, col = divmod(first, b)
            assert col == (lane % geo.lanes) * geo.e
            assert row == g * geo.rows_per_warp + lane // geo.lanes
            assert first * size % 16 == 0 and geo.e * size % 16 == 0
            assert first % min(geo.e, 16) == 0


def test_geometry_refuses_words_that_are_not_whole():
    """bf16 at E = 4 would read 8-byte words: not built, refused."""
    with pytest.raises(ValueError, match="16-byte"):
        fwht_butterfly.geometry(128, torch.bfloat16, 8, 1, e=4)


def test_kept_e_is_the_kernels():
    """The wrapper's KEPT_E is the table the library is built with."""
    import pathlib
    src = (pathlib.Path(fwht_butterfly.__file__).with_name("csrc")
           / "fwht_butterfly.cu").read_text()
    import re
    table = re.search(r"kKeptE\[5\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in table.split(",")) == tuple(
        fwht_butterfly.KEPT_E[b] for b in fwht_butterfly.BLOCK_SIZES)


def _split_fwht(x: np.ndarray, e: int) -> np.ndarray:
    """The kernel's rotation in numpy f32: lane l of a row's L = B/E lanes
    holds elements [l E, l E + E); stages h < E pair registers inside a
    lane, then stages h = m E (m = 1, 2, ..) pair lane l with lane l ^ m,
    the lane with bit m set keeping o - v and the other v + o (the
    kernel's fma(-1, v, o) and fma(1, v, o), each one rounding)."""
    m_rows, b = x.shape
    lanes = b // e
    v = x.reshape(m_rows, lanes, e).astype(np.float32).copy()
    h = 1
    while h < e:
        for j in range(e):
            if j & h == 0:
                p, r = v[..., j].copy(), v[..., j + h].copy()
                v[..., j], v[..., j + h] = p + r, p - r
        h *= 2
    lane = np.arange(lanes)
    m = 1
    while m < lanes:
        o = v[:, lane ^ m, :]
        v = np.where(((lane & m) != 0)[None, :, None], o - v, v + o)
        m *= 2
    return v.reshape(m_rows, b)


@pytest.mark.parametrize("b", fwht_butterfly.BLOCK_SIZES)
def test_kept_lane_split_is_fwht_bit_for_bit(b, rng):
    """The kept split (in-lane stages h < E, cross-lane stages h >= E) of
    every B equals ``core.ash.fwht`` bit for bit, on TP-like rows scaled as
    the kernel scales them; and so does every E of the sweep."""
    from repro_torch.core import ash
    x = tp_like(rng, (64, b)) * np.float32(37.0)
    want = ash.fwht(torch.from_numpy(x)).numpy()
    for e in sorted({fwht_butterfly.KEPT_E[b], 8, 16, 32}):
        if 1 <= b // e <= 32:
            got = _split_fwht(x, e)
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def _split_sum_of_squares(x: np.ndarray, e: int) -> np.ndarray:
    """The kernel's sum of squares in numpy f32: each square rounded,
    adjacent pairs summed inside a lane's E elements, then lanes l and
    l ^ o for o = 1, 2, .. (every lane of the row ends with the sum)."""
    m_rows, b = x.shape
    lanes = b // e
    sq = (x.astype(np.float32) * x.astype(np.float32)).reshape(m_rows, lanes,
                                                               e)
    h = 1
    while h < e:
        sq[..., 0::2 * h] = sq[..., 0::2 * h] + sq[..., h::2 * h]
        h *= 2
    ss = sq[..., 0]
    lane = np.arange(lanes)
    o = 1
    while o < lanes:
        ss = ss + ss[:, lane ^ o]
        o *= 2
    assert (ss == ss[:, :1]).all()
    return ss[:, 0]


@pytest.mark.parametrize("b", fwht_butterfly.BLOCK_SIZES)
def test_kept_lane_split_sums_squares_as_the_plain_version(b, rng):
    """The kernel's lane split of the sum of squares is the plain
    version's pairwise tree (``ref.pairwise_sum``) bit for bit, for the
    kept E and every E of the sweep."""
    x = tp_like(rng, (64, b)) * np.float32(3.0)
    want = ref.pairwise_sum(torch.from_numpy(x) ** 2).numpy()
    for e in sorted({fwht_butterfly.KEPT_E[b], 8, 16, 32}):
        if 1 <= b // e <= 32:
            np.testing.assert_array_equal(
                _split_sum_of_squares(x, e).view(np.int32),
                want.view(np.int32))


def _alpha_model(x: np.ndarray, tau: float, eps: float) -> np.ndarray:
    """K7's alpha in numpy f32: the squares' pairwise tree, / B, + eps,
    numpy's correctly rounded f32 root, tau / sigma (each step one IEEE
    rounding, as the kernel's sqrtf)."""
    sq = x * x
    while sq.shape[-1] > 1:
        sq = sq[..., 0::2] + sq[..., 1::2]
    v = sq[..., 0] / np.float32(x.shape[-1]) + np.float32(eps)
    return np.float32(tau) / np.sqrt(v)


def test_plain_alpha_takes_the_correctly_rounded_root():
    """K7's plain alpha is the numpy model's bit for bit on rows where
    PyTorch's f32 ``sqrt`` on the CPU is off (its root is not always
    correctly rounded there): rows found by a seeded search of TP-like
    draws, whose torch root of the plain version's own sigma^2 differs
    from the correctly rounded one."""
    gen = np.random.default_rng(152)
    cfg = TacoConfig()
    found = []
    for _ in range(64):
        x = tp_like(gen, (4096, 256))
        v = (ref.pairwise_sum(torch.from_numpy(x) ** 2) / 256
             + cfg.eps).numpy()
        off = torch.sqrt(torch.from_numpy(v)).numpy() != np.sqrt(v)
        found.append(x[off])
        if sum(len(f) for f in found) >= 16:
            break
    x = np.concatenate(found)
    assert len(x) >= 16, "no row where torch's f32 root is off"
    _, a, _ = fwht_butterfly.compress_blocks_butterfly(torch.from_numpy(x),
                                                       cfg)
    want = _alpha_model(x, cfg.tau, cfg.eps)
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  want.view(np.int32))
