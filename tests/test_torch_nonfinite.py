"""Rows holding NaN or inf through the port's compress operators K1
(``compress_blocks``), K2 (``compress_wire``) and K7
(``compress_blocks_butterfly``), held against the JAX package, and their
outputs decoded through the plain K3-K6.

Each input is 16 TP-like rows of B = 256 or 64 into which
``ref.plant_nonfinite`` writes a row with one NaN, one with +inf, one with
-inf, one of zeros but one element of 3e19 (its square overflows: alpha
0) and an all-zero row.  The wrappers run their plain versions here (CPU
tensors); the JAX side is ``repro.kernels.ref`` and the Pallas kernels in
interpret mode (those run in f32 whatever the compute dtype, so they are
compared at an f32 compute dtype only).

Tolerances: the planted rows under ``ref.NONFINITE_RULE`` (alpha and s
bit for bit or NaN on both sides, int8 codes equal, fp8 bytes equal or
NaN bytes on both sides: the JAX package writes e5m2's NaN as 0x7E /
0xFE where PyTorch writes 0x7F / 0xFF); the ordinary rows beside them
under ``tests/test_torch_blocks.py``'s cross-package tolerances (alpha
and s within rtol 1e-5, or ``ref.BF16_RTOL`` at a bf16 compute dtype;
under 1% of the payload values apart; K7's s within rtol 1e-4 as
``tests/test_torch_butterfly.py``); decoded values NaN at the same
elements and the rest within ``ref.DECODE_RTOL`` / ``DECODE_ATOL`` (the
bf16 rule of ``ref.check_decoded_close`` at a bf16 compute dtype).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core.taco import TacoConfig as JConfig
from repro.kernels import ref as jref
from repro.kernels.ash_compress import (compress_blocks_pallas,
                                        compress_wire_pallas)
from repro.kernels.fwht_butterfly import compress_blocks_butterfly as jk7
from repro_torch.core import quant
from repro_torch.core.taco import TacoConfig
from repro_torch.kernels import (ash_compress, ash_decompress,
                                 fwht_butterfly, ref)
from test_torch_dist import one_thread  # noqa: F401  (autouse)

FORMATS = ["e4m3", "e5m2", "int8"]
BLOCKS = [256, 64]
ROWS = 16


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def planted(rng, b, rows=ROWS):
    """(rows, b) f32 TP-like rows with ref.NONFINITE_KINDS planted, and the
    planted rows."""
    return ref.plant_nonfinite(torch.from_numpy(tp_like(rng, (rows, b))),
                               rng)


def cfgs(b, fmt, cd="float32", gs=None, metadata="dual"):
    kw = dict(block_size=b, fmt=fmt, compute_dtype=cd, quant_group_size=gs,
              metadata=metadata)
    return TacoConfig(**kw), JConfig(impl="pallas_interpret", **kw)


def from_jax(a, dtype=None):
    """A JAX array as a torch tensor: fp8 bits as the fp8 ``dtype``, bf16
    widened to f32 (exact)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return torch.from_numpy(a.view(np.uint8)).view(dtype)
    return torch.from_numpy(a)


def jax_out(out, dtype):
    """A JAX compress's (q, alpha, s) as torch tensors, q as ``dtype``."""
    q, a, s = out
    return from_jax(q, dtype), from_jax(a), from_jax(s)


def hold(got, want, cfg, planted_rows, s_rtol=None):
    """``got`` = (q, alpha | None, s) against ``want``: the planted rows
    under ref.NONFINITE_RULE, the others under the cross-package
    tolerances of this module's docstring."""
    fmt = cfg.format_spec
    apart = ref.nonfinite_apart(got, want, fmt)
    assert int(apart[planted_rows].sum()) == 0, \
        f"planted rows {planted_rows}: {apart[planted_rows].tolist()} " \
        f"values apart ({ref.NONFINITE_RULE})"
    ordinary = [r for r in range(got[0].shape[0]) if r not in planted_rows]
    (qg, ag, sg), (qw, aw, sw) = (
        (o[0][ordinary], None if o[1] is None else o[1][ordinary],
         o[2].reshape(o[0].shape[0], -1)[ordinary]) for o in (got, want))
    rtol = ref.BF16_RTOL if cfg.compute_dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(sg, sw, rtol=s_rtol or rtol, atol=0)
    if ag is not None:
        torch.testing.assert_close(ag, aw, rtol=rtol, atol=0)
    mism = float((qg.float() != qw.float()).float().mean())
    assert mism < 0.01, f"payload mismatch fraction {mism}"


@pytest.mark.parametrize("gs", [None, 8])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("b", BLOCKS)
def test_k1_plain_matches_the_jax_reference(b, fmt, cd, gs, rng):
    x, rows = planted(rng, b)
    cfg, jc = cfgs(b, fmt, cd, gs)
    got = ash_compress.compress_blocks(x, cfg)
    want = jref.compress_blocks_ref(jnp.asarray(x.numpy()), jc)
    hold(got, jax_out(want, got[0].dtype), cfg, rows)


@pytest.mark.parametrize("gs", [None, 8])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("b", BLOCKS)
def test_k1_plain_matches_the_interpret_kernel(b, fmt, gs, rng):
    x, rows = planted(rng, b)
    cfg, jc = cfgs(b, fmt, gs=gs)
    got = ash_compress.compress_blocks(x, cfg)
    want = compress_blocks_pallas(jnp.asarray(x.numpy()), jc, interpret=True)
    hold(got, jax_out(want, got[0].dtype), cfg, rows)


@pytest.mark.parametrize("metadata", ["dual", "folded"])
@pytest.mark.parametrize("gs", [None, 8])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("b", BLOCKS)
def test_k2_plain_matches_the_jax_package(b, fmt, cd, gs, metadata, rng):
    """K2's wire against the JAX package's: its wire kernel in interpret
    mode at an f32 compute dtype, its reference's blocks packed into the
    shared layout at bf16."""
    x, rows = planted(rng, b)
    cfg, jc = cfgs(b, fmt, cd, gs, metadata)
    slots, n = 2, ROWS // 2 * b
    x2 = x.reshape(slots, n)
    got = ash_compress.compress_wire(x2, cfg)
    if cd == "float32":
        want = torch.from_numpy(np.array(compress_wire_pallas(
            jnp.asarray(x2.numpy()), jc, interpret=True)))
    else:
        q, a, s = jax_out(jref.compress_blocks_ref(jnp.asarray(x.numpy()),
                                                   jc), cfg.format_spec.dtype)
        want = ref.blocks_to_wire(q, a, s, cfg, slots, n)
    hold(ref.wire_fields(got, n, cfg), ref.wire_fields(want, n, cfg), cfg,
         rows)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("b", BLOCKS)
def test_k7_plain_matches_the_interpret_kernel(b, fmt, in_dtype, rng):
    x, rows = planted(rng, b)
    x = x.to(getattr(torch, in_dtype))
    cfg, jc = cfgs(b, fmt)
    got = fwht_butterfly.compress_blocks_butterfly(x, cfg)
    want = jk7(jnp.asarray(x.float().numpy()).astype(getattr(jnp, in_dtype)),
               jc, interpret=True)
    hold(got, jax_out(want, got[0].dtype), cfg, rows, s_rtol=1e-4)


def test_the_plain_int8_code_of_nan_is_zero():
    """NaN's int8 code is 0 by an explicit mapping (quant.int8_codes), in
    every plain compress that writes int8: a float NaN's conversion to an
    integer is not defined, and x86 gives 0 only as the low byte of its
    INT_MIN."""
    nan = float("nan")
    got = quant.int8_codes(torch.tensor([nan, -nan, 0.5, 1.5, -2.5, 127.0,
                                         -127.0]))
    assert got.tolist() == [0, 0, 0, 2, -2, 127, -127]
    q, s = quant.quantize_ds(torch.full((2, 32), nan), quant.get_format(
        "int8"))
    assert q.abs().max() == 0 and s.isnan().all()
    rows = torch.full((3, 64), nan)
    for cd in ("float32", "bfloat16"):
        cfg = TacoConfig(block_size=64, fmt="int8", compute_dtype=cd)
        for fn in (ref.compress_blocks_ref, ref.compress_blocks_butterfly_ref):
            q, a, s = fn(rows, cfg)
            assert q.dtype == torch.int8 and q.abs().max() == 0
            assert a.isnan().all() and s.isnan().all()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("metadata", ["dual", "folded"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decoded_nan_positions_match_the_jax_package(fmt, metadata, cd, rng):
    """The plain K3 (decompress_blocks), K4 (decompress_reduce, one peer
    non-finite), K5 (decompress_wire) and K6 (decompress_reduce_wire) on
    K1's and K2's non-finite outputs: NaN where the JAX package's
    decompress_blocks_ref / decompress_reduce_ref put it, the rest within
    the decode tolerance."""
    b = 256
    x, rows = planted(rng, b)
    cfg, jc = cfgs(b, fmt, cd, 8, metadata)
    q, a, s = ash_compress.compress_blocks(x, cfg)
    alpha = None if metadata == "folded" else a
    scale = s / a[:, None] if alpha is None else s

    def j(t):
        return None if t is None else jnp.asarray(
            t.view(torch.uint8).numpy()).view(jc.format_spec.dtype) \
            if t.dtype.is_floating_point and t.element_size() == 1 \
            else jnp.asarray(t.numpy())

    def jax_k3(q_, s_, a_):
        return from_jax(jref.decompress_blocks_ref(j(q_), j(s_), j(a_), jc))
    want3 = jax_k3(q, scale, alpha)
    # NaN, +-inf and 3e19 rows decode to NaN (the last as 0 / alpha = 0 / 0,
    # or 0 (s / 0) folded), the zero row to zeros
    assert want3[rows[:4]].isnan().all() and not want3[rows[4]].any()
    ref.check_decoded_nonfinite(
        ash_decompress.decompress_blocks(q, scale, alpha, cfg), want3, cfg)
    # two peers: the planted rows' peer sums hold a non-finite peer
    peers = (q.reshape(2, ROWS // 2, b), scale.reshape(2, ROWS // 2, -1),
             None if alpha is None else alpha.reshape(2, ROWS // 2))
    want4 = from_jax(jref.decompress_reduce_ref(*map(j, peers), jc))
    ref.check_decoded_nonfinite(
        ash_decompress.decompress_reduce(*peers, cfg), want4, cfg)
    # the wire forms, on K2's wire of the same rows as two slots
    n = ROWS // 2 * b
    wire = ash_compress.compress_wire(x.reshape(2, n), cfg)
    ref.check_decoded_nonfinite(
        ash_decompress.decompress_wire(wire, n, cfg), want3.reshape(2, n),
        cfg)
    ref.check_decoded_nonfinite(
        ash_decompress.decompress_reduce_wire(wire, n, cfg), want4, cfg)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("metadata", ["dual", "folded"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_the_card_checks_run_on_the_cpu(fmt, metadata, cd, rng):
    """``ref.check_kernels_nonfinite`` (the gpu-marked tests' and
    chip_smoke.py's held case) holds the plain versions to themselves on
    the CPU, where the wrappers run them."""
    x, rows = planted(rng, 64)
    cfg = TacoConfig(block_size=64, fmt=fmt, compute_dtype=cd,
                     quant_group_size=8, metadata=metadata)
    assert ref.check_kernels_nonfinite(x, cfg, rows) == {"kernels": 7,
                                                         "apart": 0}


@pytest.mark.parametrize("fmt", FORMATS)
def test_the_rule_refuses_dropped_nans(fmt, rng):
    """What fmaxf maxima and clip gave on the card (a NaN row's s at the
    floor, its int8 codes at -qmax) is apart under the rule; so is a NaN
    byte where the plain version writes a number."""
    x, rows = planted(rng, 256)
    cfg = TacoConfig(fmt=fmt)
    q, a, s = want = ref.compress_blocks_ref(x, cfg)
    assert s[rows[:3]].isnan().all()
    s2 = s.clone()
    s2[rows[0]] = cfg.scale_eps
    with pytest.raises(AssertionError, match="values apart"):
        ref.check_compress_nonfinite((q, a, s2), want, cfg, rows, True)
    q2 = q.clone()
    if fmt == "int8":
        q2[rows[1]] = -127
    else:
        q2.view(torch.uint8)[rows[4], 0] = 0x7F      # the zero row's code
    with pytest.raises(AssertionError, match="values apart"):
        ref.check_compress_nonfinite((q2, a, s), want, cfg, rows, False)
