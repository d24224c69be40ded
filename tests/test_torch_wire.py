"""The port's wire path — codecs, the three wire operators' plain
versions and the size-1 collectives — held against the JAX package.

Inputs come from a generator of this module's own, seeded per test.
The JAX side is taken where it is green: ``pack_wire(TacoCodec(impl=
"jnp").encode(x))`` and the interpret-mode Pallas kernels (K2
compress_wire_pallas, K5 decompress_wire_pallas, K6
decompress_reduce_wire_pallas).  Wire rows are held to the parity rule of
``repro_torch.kernels.ref``; decoded values to rtol 1e-4 / atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core import collectives as jcc
from repro.core.codecs import pack_wire as jpack
from repro.core.registry import codec_from_spec as jspec
from repro.kernels import ash_compress as jk2
from repro.kernels import ash_decompress as jk56
from repro_torch.core import collectives as cc
from repro_torch.core.codecs import pack_wire, unpack_wire
from repro_torch.core.registry import codec_from_spec
from repro_torch.kernels import ash_compress, ash_decompress, ops, ref

SPECS = ["taco", "taco:folded", "taco:g64", "taco:int8", "taco:e5m2",
         "taco:folded:g32"]


@pytest.fixture
def rng():
    """This module's own generator, made afresh for each test from the
    session fixture's seed: a test's draws no longer depend on which tests
    ran before it in the session (under another test split the shared
    generator once gave a small comparison, where the parity rule allows
    no flipped code, an input on a rounding boundary)."""
    return np.random.default_rng(12345)


def jax_codec(spec, impl="jnp"):
    return jspec(spec.replace("taco", f"taco:{impl}", 1))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_compress_wire_plain_matches_jax_pack_encode(spec, in_dtype, rng):
    n = 4096              # 12288 payload bytes: the rule allows one flip
    x = tp_like(rng, (3, n))
    codec, jc = codec_from_spec(spec), jax_codec(spec)
    xt = t(x).to(getattr(torch, in_dtype))
    got = codec.encode_wire(xt)
    want = jpack(jc.encode(jnp.asarray(x).astype(getattr(jnp, in_dtype))),
                 jc.wire_layout(n))
    ref.check_wire_parity(got, t(want), n, codec.cfg)
    # the wrapper's CPU path is the plain version: same bytes, no launch
    before = ash_compress.compress_wire.launches
    assert torch.equal(ash_compress.compress_wire(xt, codec.cfg), got)
    assert ash_compress.compress_wire.launches == before


@pytest.mark.parametrize("spec", ["taco", "taco:folded", "taco:g64",
                                  "taco:int8"])
def test_wire_plain_versions_match_interpret_kernels(spec, rng):
    """K2, K5 and K6 in Pallas interpret mode vs the port's plain
    versions of the same three operators."""
    n = 512
    codec = codec_from_spec(spec)
    jc = jax_codec(spec, "pallas_interpret")
    x = tp_like(rng, (3, n))
    wj = jk2.compress_wire_pallas(jnp.asarray(x), jc.cfg, interpret=True)
    wt = ref.compress_wire_ref(t(x), codec.cfg)
    ref.check_wire_parity(wt, t(wj), n, codec.cfg)
    dj = jk56.decompress_wire_pallas(wj, n, jc.cfg, interpret=True)
    ref.check_decoded_close(ref.decompress_wire_ref(t(wj), n, codec.cfg),
                            t(dj))
    rj = jk56.decompress_reduce_wire_pallas(wj, n, jc.cfg, interpret=True)
    ref.check_decoded_close(
        ref.decompress_reduce_wire_ref(t(wj), n, codec.cfg), t(rj))


@pytest.mark.parametrize("spec", SPECS)
def test_cross_package_decode_both_directions(spec, rng):
    n = 768
    codec, jc = codec_from_spec(spec), jax_codec(spec)
    x = tp_like(rng, (2, n))
    wt = codec.encode_wire(t(x))
    wj = jc.encode_wire(jnp.asarray(x))
    # a row written by either package decodes in the other
    for wire in (wt, t(wj)):
        got = codec.decode_wire(wire, n, torch.float32)
        want = jc.decode_wire(jnp.asarray(wire.numpy()), n, jnp.float32)
        ref.check_decoded_close(got, t(want))
        gs = codec.decode_sum_wire(wire, n, torch.float32)
        ws = jc.decode_sum_wire(jnp.asarray(wire.numpy()), n, jnp.float32)
        ref.check_decoded_close(gs, t(ws))


@pytest.mark.parametrize("spec", SPECS)
def test_fused_paths_equal_generic_composition(spec, rng):
    """Within the port the wire paths are bit-identical to pack/unpack
    composed with encode/decode (the wire format's definition)."""
    n = 512
    codec = codec_from_spec(spec)
    x = t(tp_like(rng, (3, n)))
    layout = codec.wire_layout(n)
    wire = codec.encode_wire(x)
    assert wire.dtype == torch.uint8
    assert wire.shape == (3, layout.total_bytes)
    assert torch.equal(wire, pack_wire(codec.encode(x), layout))
    torch.testing.assert_close(
        codec.decode_wire(wire, n, torch.float32),
        codec.decode(unpack_wire(wire, layout), n, torch.float32),
        rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(
        codec.decode_sum_wire(wire, n, torch.float32),
        codec.decode_sum(unpack_wire(wire, layout), n, torch.float32),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_plain_decode_of_wire_views_at_any_byte_offset(offset, slots, rng):
    """A wire that is a view at byte offset 1-3 of a larger buffer decodes
    in the plain versions of K5 and K6 (the CPU path of their wrappers)
    bit for bit as the aligned wire does, and as the JAX package decodes
    the same bytes (it bitcasts them wherever they lie)."""
    n = 512
    codec, jc = codec_from_spec("taco:g64"), jax_codec("taco:g64")
    wire = codec.encode_wire(t(tp_like(rng, (slots, n))))
    buf = torch.empty(wire.numel() + offset, dtype=torch.uint8)
    view = buf[offset:].view(wire.shape)
    view.copy_(wire)
    assert view.is_contiguous() and view.storage_offset() == offset
    jw = jnp.asarray(wire.numpy())
    for op, jop in ((ash_decompress.decompress_wire, jc.decode_wire),
                    (ash_decompress.decompress_reduce_wire,
                     jc.decode_sum_wire)):
        got = op(view, n, codec.cfg)
        assert torch.equal(got, op(wire, n, codec.cfg))
        ref.check_decoded_close(got, t(jop(jw, n, jnp.float32)).reshape(
            got.shape))


@pytest.mark.parametrize("spec", ["none", "taco", "taco:folded"])
@pytest.mark.parametrize("shape", [(4, 1, 896), (1, 1, 128), (2, 3, 100)])
def test_allreduce_size1_matches_jax(spec, shape, rng):
    """The two-shot AllReduce on a group of one: encode and decode still
    run (JAX's size-1 all_to_all / all_gather carry the wire unchanged)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    x = tp_like(rng, shape)
    xt = t(x).to(torch.bfloat16)
    got = cc.allreduce_g(xt, 1, codec_from_spec(spec), None)
    assert got.shape == xt.shape and got.dtype == torch.bfloat16
    jc = jax_codec(spec) if spec != "none" else jspec("none")
    mesh = jax.make_mesh((1,), ("model",))
    f = shard_map(lambda a: jcc._ar_impl(a, "model", jc), mesh=mesh,
                  in_specs=P(), out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(f)(jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    if spec == "none":
        assert torch.equal(got, xt)
    # bf16 output: one bf16 ulp (2^-8 relative) of the largest value
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=float(np.abs(want).max()) * 2 ** -8)


def test_group_and_ring_not_ported_yet():
    """Groups larger than one and the ring are ported now
    (tests/test_torch_dist.py); what stays out: a group given as a bare
    size, and the negotiated slot (``slot=auto``).  On a group of one the
    ring equals the monolithic hop bit for bit."""
    from repro_torch.core.registry import CommSpecError
    x = t(tp_like(np.random.default_rng(5), (4, 600))).to(torch.bfloat16)
    with pytest.raises(ValueError, match="process group"):
        cc.allreduce_g(x, 2, codec_from_spec("taco"), None)
    with pytest.raises(ValueError, match="process group"):
        cc.allreduce_g(x, 2, codec_from_spec("none"), None)
    with pytest.raises(CommSpecError, match="slot=auto"):
        codec_from_spec("taco:slot=auto")
    mono = cc.allreduce_g(x, 1, codec_from_spec("taco"), None)
    for spec in ("taco:chunks=4", "taco:chunks=3:schedule=serial"):
        assert torch.equal(cc.allreduce_g(x, 1, codec_from_spec(spec), None),
                           mono)
    assert cc.copy_f(x, 1, None, None) is x


def test_wrappers_raise_off_cpu_without_plain_fallback(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device never reaches the plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version called off the CPU")
    for name in ("compress_wire_ref", "decompress_wire_ref",
                 "decompress_reduce_wire_ref", "compress_blocks_ref",
                 "decompress_blocks_ref", "decompress_reduce_ref"):
        monkeypatch.setattr(ref, name, boom)
    cfg = codec_from_spec("taco").cfg
    x = torch.zeros(1, 256, device="meta")
    w = torch.zeros(1, 264, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ash_compress.compress_wire(x, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ash_decompress.decompress_wire(w, 256, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ash_decompress.decompress_reduce_wire(w, 256, cfg)
    # the block operators are kernel wrappers too
    q = torch.zeros(1, 256, dtype=torch.float8_e4m3fn, device="meta")
    s = torch.zeros(1, 1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.compress_blocks(x, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decompress_blocks(q, s, None, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decompress_reduce(q[None], s[None], None, cfg)


def test_kernel_coverage_rule():
    for spec in ("taco:folded:g32", "taco:b128", "taco:cdbfloat16"):
        assert ash_compress.supported(codec_from_spec(spec).cfg)
        ash_compress.check_supported(codec_from_spec(spec).cfg)
    for spec in ("taco:hadamard", "taco:tensorscale"):
        assert not ash_compress.supported(codec_from_spec(spec).cfg)
    with pytest.raises(NotImplementedError, match="CUDA wire kernels"):
        ash_compress.check_supported(codec_from_spec("taco:b1024").cfg)
    assert ash_compress.wire_geometry(codec_from_spec("taco").cfg, 3584) \
        == jk2.wire_geometry(jax_codec("taco").cfg, 3584)
