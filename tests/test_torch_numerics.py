"""The port's numerics core (quant, ash, taco, kernels/ref) held against
the JAX package on the same numpy inputs.

Tolerances: the JAX package's own kernel-vs-oracle ones (tests/
test_kernels.py) — rtol 1e-5 on alpha and s, rtol 1e-4 / atol 1e-5 on
decoded values — and for payloads the parity rule of
``repro_torch.kernels.ref`` (at most 1e-4 of the bytes, each one
code apart: the two packages sum the f32 rotation in different orders).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core import ash as jash
from repro.core import quant as jquant
from repro.core import taco as jtaco
from repro.kernels import ref as jref
from repro_torch.core import ash, quant, taco
from repro_torch.kernels import ref

FMTS = ["e4m3", "e5m2", "int8"]


def jcfg(**kw):
    return jtaco.TacoConfig(impl="jnp", **kw)


def t(a):
    return torch.from_numpy(np.array(a))


def check_payload(qt, qj, cfg):
    """Storage-dtype payloads (torch / jax) under the parity rule."""
    pt = taco._storage_to_wire(qt, cfg.format_spec)
    pj = jtaco._storage_to_wire(qj, jquant.get_format(cfg.fmt))
    codes = ref.payload_codes
    d = (codes(pt, cfg) - codes(t(np.asarray(pj)), cfg)).abs()
    assert int(d.max()) <= 1
    assert int((d != 0).sum()) <= ref.PAYLOAD_FLIP_FRACTION * d.numel()


def test_format_table_matches_jax():
    for name in FMTS:
        a, b = quant.get_format(name), jquant.get_format(name)
        assert (a.qmax, a.is_float) == (b.qmax, b.is_float)
        assert np.dtype(b.dtype).itemsize == torch.empty(
            (), dtype=a.dtype).element_size()
    with pytest.raises(ValueError):
        quant.get_format("e3m4")


def test_taco_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jtaco.TacoConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(taco.TacoConfig)}
    assert jf == tf
    with pytest.raises(ValueError, match="TPU"):
        taco.TacoConfig(impl="pallas")


@pytest.mark.parametrize("b", [16, 128, 256])
def test_hadamard_and_fwht_match_jax(b, rng):
    h = ash.hadamard_matrix(b)
    np.testing.assert_array_equal(h.numpy(),
                                  np.asarray(jash.hadamard_matrix(b)))
    x = rng.normal(size=(5, b)).astype(np.float32)
    np.testing.assert_allclose(ash.fwht(t(x)).numpy(),
                               np.asarray(jash.fwht(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ash.fwht(t(x)).numpy() / np.sqrt(b),
                               (t(x) @ h).numpy(), rtol=1e-5, atol=1e-5)


def test_block_partition_roundtrip_matches_jax(rng):
    x = rng.normal(size=(3, 7, 30)).astype(np.float32)
    bt, n = ash.block_partition(t(x), 256)
    bj, nj = jash.block_partition(jnp.asarray(x), 256)
    assert n == nj
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(
        ash.block_unpartition(bt, n, x.shape).numpy(), x)


def test_ash_forward_matches_jax(rng):
    x = tp_like(rng, (16, 256))
    zt, at = ash.ash_forward(t(x))
    zj, aj = jash.ash_forward(jnp.asarray(x))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("group", [None, 32])
def test_quantize_ds_matches_jax(fmt, group, rng):
    z = tp_like(rng, (32, 256))
    cfg = taco.TacoConfig(fmt=fmt, quant_group_size=group)
    qt, st = quant.quantize_ds(t(z), cfg.format_spec, group_size=group)
    qj, sj = jquant.quantize_ds(jnp.asarray(z), jquant.get_format(fmt),
                                group_size=group)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    check_payload(qt, qj, cfg)
    np.testing.assert_allclose(
        quant.dequantize_ds(qt, st, cfg.format_spec).numpy(),
        np.asarray(jquant.dequantize_ds(qj, sj, jquant.get_format(fmt))),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, {"quant_group_size": 64},
                                {"transform": "hadamard"},
                                {"scale_granularity": "tensor"}])
def test_compress_blocks_ref_matches_jax(fmt, in_dtype, kw, rng):
    x = tp_like(rng, (40, 256))
    cfg = taco.TacoConfig(fmt=fmt, **kw)
    xt = t(x).to(getattr(torch, in_dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, in_dtype))
    qt, at, st = ref.compress_blocks_ref(xt, cfg)
    qj, aj, sj = jref.compress_blocks_ref(xj, jcfg(fmt=fmt, **kw))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    check_payload(qt, qj, cfg)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("fmt", ["e4m3", "int8"])
def test_decompress_blocks_ref_matches_jax(folded, fmt, rng):
    x = tp_like(rng, (24, 256))
    cj = jcfg(fmt=fmt)
    q, a, s = jref.compress_blocks_ref(jnp.asarray(x), cj)
    s_in, a_in = (s / a[:, None], None) if folded else (s, a)
    want = jref.decompress_blocks_ref(q, s_in, a_in, cj)
    qt = t(np.asarray(jtaco._storage_to_wire(q, cj.format_spec)))
    qt = taco._wire_to_storage(qt, quant.get_format(fmt))
    got = ref.decompress_blocks_ref(qt, t(s_in),
                                    None if a_in is None else t(a_in),
                                    taco.TacoConfig(fmt=fmt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("peers", [1, 3])
def test_decompress_reduce_ref_matches_jax(peers, rng):
    cj = jcfg()
    qs, ss, aas = [], [], []
    for _ in range(peers):
        q, a, s = jref.compress_blocks_ref(jnp.asarray(tp_like(rng, (9, 256))),
                                           cj)
        qs.append(q), ss.append(s), aas.append(a)
    q, s, a = jnp.stack(qs), jnp.stack(ss), jnp.stack(aas)
    want = np.asarray(jref.decompress_reduce_ref(q, s, a, cj))
    qt = t(np.asarray(jtaco._storage_to_wire(q, cj.format_spec))).view(
        torch.float8_e4m3fn)
    got = ref.decompress_reduce_ref(qt, t(s), t(a), taco.TacoConfig())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scale_eps", [1e-30, 1e-20, 1e-6])
def test_scale_floor_zero_and_denormal_blocks_match_jax(scale_eps):
    """The s floor is cfg.scale_eps on both packages: all-zero and
    denormal blocks quantize alike, and zero blocks decode to exact
    zeros.  XLA on the CPU flushes subnormal inputs to zero while PyTorch
    (and the CUDA kernels, built without fast math) keep them, so the JAX
    result is held against the port on the flushed input, and the port's
    own result on the subnormal input is checked for the floor."""
    zero = np.zeros((4, 256), np.float32)
    denormal = np.full((4, 256), 1e-38, np.float32)
    mixed = np.concatenate([zero, denormal,
                            np.linspace(-1e-35, 1e-35, 256,
                                        dtype=np.float32)[None]])
    tiny = np.finfo(np.float32).tiny
    cfg = taco.TacoConfig(scale_eps=scale_eps)
    cj = jcfg(scale_eps=scale_eps)
    for x in (zero, denormal, mixed):
        flushed = np.where(np.abs(x) < tiny, np.float32(0), x)
        qt, at, st = ref.compress_blocks_ref(t(flushed), cfg)
        qj, aj, sj = jref.compress_blocks_ref(jnp.asarray(x), cj)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
        check_payload(qt, qj, cfg)
        qt, at, st = ref.compress_blocks_ref(t(x), cfg)
        assert float(st.min()) >= float(np.float32(scale_eps))
        dt = ref.decompress_blocks_ref(qt, st, at, cfg)
        assert torch.isfinite(dt).all()
        if x is zero:
            np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
            assert float(dt.abs().max()) == 0.0


@pytest.mark.parametrize("kw", [{}, {"metadata": "folded"},
                                {"quant_group_size": 64, "fmt": "int8"},
                                {"block_size": 128}])
@pytest.mark.parametrize("n", [256, 1024])
def test_wire_components_equal_jax(kw, n):
    if n % kw.get("block_size", 256):
        pytest.skip("n not a multiple of the block")
    assert taco.wire_components(taco.TacoConfig(**kw), n) == \
        jtaco.wire_components(jcfg(**kw), n)
