"""The rest of the numerics and accounting API held against the JAX package
on the same numpy inputs: ``taco.compress`` / ``decompress`` /
``wire_bytes`` / ``raw_bytes``, ``ash.ash_inverse``, ``quant.wire_dtype``,
``codecs.achieved_wire_bytes`` / ``wire_bytes_per_element``, the SDP4bit
codec (``core/dp_compress.py``, ``Sdp4BitCodec``) and the trainer's
``comm/*`` keys (``telemetry.comm_metrics``).

Tolerances.  TACO: the ``tests/test_kernels.py`` ones (rtol 1e-5 on alpha
and s, rtol 1e-4 / atol 1e-5 on decoded values of the same payload) and
the payload parity rule of ``repro_torch.kernels.ref``.  SDP4bit: the
parity rule of ``repro_torch.core.dp_compress`` — at most 1e-4 of the
int4 codes differ, each by one; scales within rtol 1e-5; each decoded
128-block within the distance its differing codes and scales allow (the
rotation is orthonormal, so one code step moves a block by its scale in
L2), plus 1e-6 of its norm.  Byte counts must be equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import tp_like
from test_torch_numerics import check_payload
from test_torch_route import _accuracy_specs, _blocksize_specs
from repro.core import ash as jash
from repro.core import codecs as jcodecs
from repro.core import dp_compress as jdp
from repro.core import quant as jquant
from repro.core import taco as jtaco
from repro.core import telemetry as jtelemetry
from repro.core.registry import codec_from_spec as jcodec_from_spec
from repro.core.registry import from_spec as jfrom_spec
from repro_torch.core import ash, codecs, dp_compress, quant, taco, telemetry
from repro_torch.core.registry import codec_from_spec, from_spec

TACO_SPECS = sorted(set(_accuracy_specs() + _blocksize_specs()))
SDP_SPECS = ["sdp4bit", "sdp4bit:b64", "sdp4bit:norot"]
PLANS = ["baseline", "taco", "tp=taco,grad_rs=sdp4bit",
         "tp=taco:folded:chunks=4,grad_rs=sdp4bit:chunks=2,warmup=3",
         "grad_rs=sdp4bit:b64:norot,weight_ag=sdp4bit",
         "tp_fwd=taco:int8,tp_bwd=taco:e5m2:chunks=2:schedule=serial"]


def t(a):
    return torch.from_numpy(np.array(a))


def jspec(spec):
    """The JAX codec of a port spec (taco on its oracle implementation)."""
    return jcodec_from_spec(spec.replace("taco", "taco:jnp", 1))


# --------------------------------------------------------------------------
# quant / ash
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
def test_wire_dtype_matches_jax(fmt):
    got = quant.get_format(fmt).wire_dtype
    want = np.dtype(jquant.get_format(fmt).wire_dtype)
    assert torch.empty((), dtype=got).numpy().dtype == want


@pytest.mark.parametrize("b", [64, 256])
def test_ash_inverse_matches_jax(b, rng):
    z = rng.normal(0, 1, (40, b)).astype(np.float32)
    alpha = rng.uniform(0.5, 4.0, 40).astype(np.float32)
    want = np.asarray(jash.ash_inverse(jnp.asarray(z), jnp.asarray(alpha)))
    got = ash.ash_inverse(t(z), t(alpha)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    blocks = rng.normal(0, 0.02, (40, b)).astype(np.float32)
    zz, aa = ash.ash_forward(t(blocks))
    np.testing.assert_allclose(ash.ash_inverse(zz, aa).numpy(), blocks,
                               rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------
# taco: compress / decompress / wire_bytes / raw_bytes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", TACO_SPECS)
def test_compress_decompress_and_bytes_match_jax(spec):
    gen = np.random.default_rng(sum(map(ord, spec)))
    x = tp_like(gen, (4, 50, 130))                # 26000: pads the tail
    cfg, jcfg = codec_from_spec(spec).cfg, jspec(spec).cfg
    c = taco.compress(t(x), cfg)
    jc = jtaco.compress(jnp.asarray(x), jcfg)
    fmt = cfg.format_spec
    check_payload(taco._wire_to_storage(c.payload, fmt),
                  jtaco._wire_to_storage(jc.payload, jcfg.format_spec), cfg)
    np.testing.assert_allclose(c.scale.numpy(), np.asarray(jc.scale),
                               rtol=1e-5)
    assert (c.alpha is None) == (jc.alpha is None)
    if c.alpha is not None:
        np.testing.assert_allclose(c.alpha.numpy(), np.asarray(jc.alpha),
                                   rtol=1e-5)
    assert taco.wire_bytes(c) == jtaco.wire_bytes(jc)
    assert taco.raw_bytes(t(x)) == jtaco.raw_bytes(jnp.asarray(x))
    assert taco.raw_bytes(t(x).bfloat16()) == \
        jtaco.raw_bytes(jnp.asarray(x, jnp.bfloat16))
    # the receiver on the same wire value (JAX's) in both packages
    same = taco.Compressed(t(np.asarray(jc.payload)),
                           t(np.asarray(jc.scale)),
                           None if jc.alpha is None
                           else t(np.asarray(jc.alpha)))
    got = taco.decompress(same, cfg, shape=x.shape, dtype=torch.float32)
    want = jtaco.decompress(jc, jcfg, shape=x.shape, dtype=jnp.float32)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    back = taco.decompress(c, cfg, shape=x.shape, dtype=torch.bfloat16)
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == x.shape


# --------------------------------------------------------------------------
# codec accounting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["none"] + TACO_SPECS + SDP_SPECS)
def test_wire_bytes_per_element_and_achieved_bytes_match_jax(spec):
    codec, jcodec = codec_from_spec(spec), jspec(spec)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        assert codecs.wire_bytes_per_element(codec, dtype) == \
            jcodecs.wire_bytes_per_element(jcodec, jdtype)
    if spec == "none":
        assert codec.wire_layout(1024) is None
        return
    x = tp_like(np.random.default_rng(5), (3, 1024))
    layout, jlayout = codec.wire_layout(1024), jcodec.wire_layout(1024)
    assert [(c.name, c.dtype, c.size, c.offset) for c in layout.components] \
        == [(c.name, c.dtype, c.size, c.offset) for c in jlayout.components]
    wire = codec.encode_wire(t(x))
    jwire = jcodec.encode_wire(jnp.asarray(x))
    assert tuple(wire.shape) == jwire.shape
    got = codecs.achieved_wire_bytes(wire, layout)
    want = np.asarray(jcodecs.achieved_wire_bytes(jwire, jlayout))
    assert got.dtype == torch.uint32 and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", PLANS)
@pytest.mark.parametrize("warm", [None, True, False])
def test_comm_metrics_match_jax(spec, warm):
    plan, jplan = from_spec(spec), jfrom_spec(spec)
    got = telemetry.comm_metrics(plan, spec=spec, warmup_active=warm)
    want = jtelemetry.comm_metrics(jplan, spec=spec, warmup_active=warm)
    assert got == want
    bare = telemetry.comm_metrics(plan.steady())
    assert bare == jtelemetry.comm_metrics(jplan.steady())
    assert "comm/spec" not in bare


# --------------------------------------------------------------------------
# SDP4bit
# --------------------------------------------------------------------------

def test_int4_pack_unpack_roundtrip(rng):
    """The case of tests/test_collectives.py on the port, and the packed
    bytes equal to the JAX package's."""
    q = rng.integers(-8, 8, (16, 128)).astype(np.int8)
    packed = dp_compress.int4_pack(t(q))
    assert packed.shape == (16, 64) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(dp_compress.int4_unpack(packed).numpy(), q)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jdp.int4_pack(jnp.asarray(q))))
    np.testing.assert_array_equal(
        dp_compress.int4_unpack(t(np.asarray(jdp.int4_pack(
            jnp.asarray(q))))).numpy(), q)


def test_sdp4bit_codec_roundtrip(rng):
    """The case of tests/test_collectives.py on the port."""
    codec = codecs.Sdp4BitCodec()
    x = t(rng.normal(0, 1.0, (4, 1024)).astype(np.float32))
    back = codec.decode(codec.encode(x), 1024, torch.float32)
    assert float((back - x).norm() / x.norm()) < 0.15  # 4-bit, white noise
    assert codec.bytes_per_element() < 0.6


@pytest.mark.parametrize("spec", SDP_SPECS)
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_sdp4bit_codec_matches_jax(spec, scale):
    """encode (wire), decode and decode_sum of the port against the JAX
    codec on the same inputs, to the parity rule; the port's decode of the
    JAX wire against the JAX decode of it within the same rule (no code
    differs there)."""
    gen = np.random.default_rng(7 + len(spec))
    codec, jcodec = codec_from_spec(spec), jspec(spec)
    block = codec.block
    p, n = 3, 8192
    x = np.stack([tp_like(gen, (4, n), scale=0.02 * scale,
                          tail=2.0 * scale) for _ in range(p)])
    wire = torch.stack([codec.encode_wire(t(v)) for v in x])
    jwire = np.stack([np.asarray(jcodec.encode_wire(jnp.asarray(v)))
                      for v in x])
    par = dp_compress.check_wire_parity(wire, t(jwire), n, block)
    assert par["codes"] == p * 4 * n
    dec = codec.decode_wire(wire, n, torch.float32)
    jdec = np.asarray(jcodec.decode_wire(jnp.asarray(jwire), n, jnp.float32))
    dp_compress.check_decoded(dec, t(jdec), par["bound"], block)
    same = codec.decode_wire(t(jwire), n, torch.float32)
    zero = dp_compress.check_wire_parity(t(jwire), t(jwire), n, block)
    dp_compress.check_decoded(same, t(jdec), zero["bound"], block)
    # decode_sum of the peer stack of slot 1, one inverse rotation
    ssum = codec.decode_sum_wire(wire[:, 1], n, torch.float32)
    jsum = np.asarray(jcodec.decode_sum_wire(jnp.asarray(jwire[:, 1]), n,
                                             jnp.float32))
    assert tuple(ssum.shape) == (n,) and jsum.shape == (n,)
    dp_compress.check_decoded(ssum, t(jsum),
                              par["bound"][:, 1].sum(dim=0), block)
    # the components themselves: bf16 input, dtype kept on the decode
    packed, s = codec.encode(t(x[0]).bfloat16())
    jpacked, js = jcodec.encode(jnp.asarray(x[0], jnp.bfloat16))
    assert packed.shape == jpacked.shape and s.shape == js.shape
    assert codec.decode((packed, s), n, torch.bfloat16).dtype == \
        torch.bfloat16
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)


def test_parity_rule_catches_an_independent_codec():
    """A codec that differs from the reference by more than a rounding
    (here: no rotation against the rotation) fails the rule."""
    gen = np.random.default_rng(11)
    x = t(tp_like(gen, (2, 4096)))
    a = codecs.Sdp4BitCodec().encode_wire(x)
    b = codecs.Sdp4BitCodec(rotate=False).encode_wire(x)
    with pytest.raises(AssertionError, match="int4"):
        dp_compress.check_wire_parity(a, b, 4096, 128)
