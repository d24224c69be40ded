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
