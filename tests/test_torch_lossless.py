"""The port's lossless tier (``repro_torch.core.lossless``, the ``+zle``
stage of the registry) held against the JAX package's
(``repro.core.lossless``) on the CPU, with seeded numpy inputs.

  * ZLE bytes: on the same inner wire bytes, ``zle_encode`` gives the JAX
    package's length, bitmap and data bit for bit, and ``zle_decode``
    inverts it, across the reference's shapes and group sizes; the
    lengths equal the numpy oracle's.
  * Interchange: a ZLE wire one package writes decodes in the other —
    the stage bit for bit, the inner taco decode within the decode
    tolerance of ``tests/test_kernels.py`` (rtol 1e-4, atol 1e-5; the
    oracle is ``taco:jnp``).
  * Entropy: ``byte_entropy_bits`` within 1e-5 of the JAX package's.
  * Stacks: a ``ZleCodec`` hop equals its inner codec's hop bit for bit
    over ``taco``, ``sdp4bit``, ``tahquant`` and ``int8``.
  * The variable layout, the header read at any byte offset, the grammar
    of the stage and the achieved floor probe, each against the JAX
    package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core import codecs as jcodecs
from repro.core import lossless as JL
from repro.core import registry as jreg
from repro.core import telemetry as jtel
from repro_torch.core import codecs as tcodecs
from repro_torch.core import collectives as cc
from repro_torch.core import lossless as TL
from repro_torch.core import registry as treg
from repro_torch.core import telemetry as ttel

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(1, 16), (3, 100), (2, 4, 333), (5, 256)]
GROUPS = [1, 4, 8, 16, 32, 64]
BASES = ["taco", "taco:folded", "sdp4bit", "tahquant", "int8:g64"]


def _sparse_rows(rng, shape, group=TL.GROUP_BYTES, zero_frac=0.5):
    """uint8 rows with ``zero_frac`` of their ``group``-byte groups zeroed
    (the JAX package's test input)."""
    x = rng.integers(1, 256, shape, dtype=np.uint8)
    w = shape[-1]
    groups = -(-w // group)
    zero = rng.random(shape[:-1] + (groups,)) < zero_frac
    for g in range(groups):
        lo, hi = g * group, min((g + 1) * group, w)
        x[..., lo:hi] = np.where(zero[..., g:g + 1], 0, x[..., lo:hi])
    return x


def _jax_spec(spec):
    """The JAX package's spec of a port codec spec: taco through its
    oracle (``jnp``)."""
    if not spec.startswith("taco"):
        return spec
    head, sep, rest = spec.partition(":")
    return f"{head}:jnp{sep}{rest}"


# --------------------------------------------------------------------------
# zle_encode / zle_decode against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_zle_bytes_match_jax(shape, group, rng):
    x = _sparse_rows(rng, shape, group=max(group, 4))
    want = jax.jit(lambda v: JL.zle_encode(v, group=group))(jnp.asarray(x))
    got = TL.zle_encode(torch.from_numpy(x), group=group)
    for name, w, g in zip(("length", "bitmap", "data"), want, got):
        assert g.dtype == {"length": torch.uint32}.get(name, torch.uint8)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    dec = TL.zle_decode(got[1], got[2], shape[-1], group=group)
    np.testing.assert_array_equal(dec.numpy(), x)
    lens = got[0].numpy()[..., 0]
    for idx in np.ndindex(*shape[:-1]):
        assert lens[idx] == TL._np_reference_zle(x[idx], group=group)[0]
        assert TL._np_reference_zle(x[idx], group=group)[0] == \
            JL._np_reference_zle(x[idx], group=group)[0]


def test_zle_all_zero_and_all_nonzero_extremes(rng):
    w = 160                                  # 10 groups, 2 bitmap bytes
    length, bitmap, data = TL.zle_encode(torch.zeros((2, w), dtype=torch.uint8))
    assert length.to(torch.int64).tolist() == [[4 + 2], [4 + 2]]
    assert not bitmap.any() and not data.any()
    dense = rng.integers(1, 256, (2, w), dtype=np.uint8)
    length, bitmap, data = TL.zle_encode(torch.from_numpy(dense))
    assert (length.to(torch.int64) == 4 + 2 + 10 * 16).all()
    np.testing.assert_array_equal(
        TL.zle_decode(bitmap, data, w).numpy(), dense)


def test_zle_compaction_is_stable_and_tail_zeroed():
    row = np.zeros(64, np.uint8)             # groups 1 and 3 nonzero
    row[16:32] = np.arange(1, 17)
    row[48:64] = np.arange(101, 117)
    length, bitmap, data = TL.zle_encode(torch.from_numpy(row[None]))
    assert int(length[0, 0]) == 4 + 1 + 2 * 16
    assert int(bitmap[0, 0]) == 0b1010
    np.testing.assert_array_equal(data[0, :16].numpy(), row[16:32])
    np.testing.assert_array_equal(data[0, 16:32].numpy(), row[48:64])
    assert not data[0, 32:].any()


@pytest.mark.parametrize("group", [1, 16, 64])
def test_byte_entropy_matches_jax(group, rng):
    for shape in SHAPES:
        x = _sparse_rows(rng, shape, group=group)
        want = float(JL.byte_entropy_bits(jnp.asarray(x)))
        got = TL.byte_entropy_bits(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-5, (shape, float(got), want)
    assert float(TL.byte_entropy_bits(torch.zeros(64, dtype=torch.uint8))) \
        == 0.0


# --------------------------------------------------------------------------
# the variable layout and its header
# --------------------------------------------------------------------------

def test_zle_layout_matches_jax():
    for w in (1, 100, 1024, 8518):
        for g in (1, 4, 16, 64):
            t, j = TL.zle_wire_layout(w, g), JL.zle_wire_layout(w, g)
            assert t.variable and j.variable
            assert [(c.name, c.dtype, c.size, c.offset)
                    for c in t.components] == \
                [(c.name, c.dtype, c.size, c.offset) for c in j.components]
            assert TL.zle_slot_bytes(w, g) == JL.zle_slot_bytes(w, g)


def test_variable_layout_requires_uint32_header_first():
    with pytest.raises(ValueError):
        tcodecs.make_wire_layout(("bitmap", "uint8", 4), variable=True)
    with pytest.raises(ValueError):
        tcodecs.make_wire_layout(("length", "uint8", 4), variable=True)
    with pytest.raises(ValueError):
        tcodecs.make_wire_layout(("length", "uint32", 2), variable=True)
    assert not tcodecs.make_wire_layout(("payload", "uint8", 4)).variable


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_achieved_wire_bytes_reads_headers_at_any_offset(offset, rng):
    """The header is read byte by byte: a wire that is a view at byte
    offset 1-3 reads the aligned wire's values, equal to the JAX
    package's on a static and a variable layout."""
    hybrid = treg.codec_from_spec("taco+zle")
    n = 4 * hybrid.granule
    x = tp_like(rng, (3, n))
    x[1] = 0.0
    wire = hybrid.encode_wire(torch.from_numpy(x))
    lay = hybrid.wire_layout(n)
    buf = torch.zeros(wire.numel() + offset, dtype=torch.uint8)
    view = buf[offset:].view(wire.shape)
    view.copy_(wire)
    got = tcodecs.achieved_wire_bytes(view, lay)
    want = jcodecs.achieved_wire_bytes(
        jnp.asarray(wire.numpy()), JL.zle_wire_layout(
            hybrid.inner.wire_layout(n).total_bytes))
    np.testing.assert_array_equal(got.to(torch.int64).numpy(),
                                  np.asarray(want).astype(np.int64))
    assert int(got[1]) < lay.total_bytes
    static = hybrid.inner.wire_layout(n)
    assert tcodecs.achieved_wire_bytes(view, static).tolist() == \
        [static.total_bytes] * 3


# --------------------------------------------------------------------------
# the stack against the JAX package and against its own inner codec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base", BASES)
def test_zle_wire_interchange_with_jax(base, rng):
    """On the same inner wire bytes the ZLE stage writes the JAX stage's
    bytes; each package decodes the other's ZLE wire (the stage bit for
    bit, the inner decode within the decode tolerance)."""
    head, sep, rest = base.partition(":")
    spec = f"{head}+zle{sep}{rest}"
    port, jax_c = treg.codec_from_spec(spec), \
        jreg.codec_from_spec(_jax_spec(spec))
    n = 4 * port.granule
    x = tp_like(rng, (3, n))
    x[1, : n // 2] = 0.0
    j_inner = np.array(jax_c.inner.encode_wire(jnp.asarray(x)))
    want = [np.asarray(a) for a in JL.zle_encode(jnp.asarray(j_inner))]
    got = TL.zle_encode(torch.from_numpy(j_inner))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    j_wire = np.array(jax_c.encode_wire(jnp.asarray(x)))
    t_wire = port.encode_wire(torch.from_numpy(x)).numpy()
    assert j_wire.shape == t_wire.shape
    # the JAX wire through the port's decoder, and the port's through JAX's
    np.testing.assert_allclose(
        port.decode_wire(torch.from_numpy(j_wire), n, torch.float32).numpy(),
        np.asarray(jax_c.decode_wire(jnp.asarray(j_wire), n, jnp.float32)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np.asarray(jax_c.decode_wire(jnp.asarray(t_wire), n, jnp.float32)),
        port.decode_wire(torch.from_numpy(t_wire), n, torch.float32).numpy(),
        rtol=RTOL, atol=ATOL)
    # the stage alone inverts the other package's stage bit for bit
    lay = port.wire_layout(n)
    _, bm, data = tcodecs.unpack_wire(torch.from_numpy(j_wire), lay)
    inner_w = port.inner.wire_layout(n).total_bytes
    np.testing.assert_array_equal(
        TL.zle_decode(bm, data, inner_w, port.group).numpy(),
        np.asarray(JL.zle_decode(*[jnp.asarray(a) for a in
                                   jcodecs.unpack_wire(jnp.asarray(j_wire),
                                                       jax_c.wire_layout(n))
                                   [1:]], inner_w, port.group)))


@pytest.mark.parametrize("group", [4, 16, 64])
@pytest.mark.parametrize("base", BASES)
def test_zle_stack_equals_inner_bitwise(base, group, rng):
    """The stage is exact: decode and the peer-summed decode through the
    stack equal the bare inner codec's bit for bit."""
    head, sep, rest = base.partition(":")
    g = "" if group == TL.GROUP_BYTES else f":g={group}"
    hybrid = treg.codec_from_spec(f"{head}+zle{sep}{rest}{g}")
    assert hybrid.group == group
    inner = hybrid.inner
    n = 4 * hybrid.granule
    x = torch.from_numpy(tp_like(rng, (3, n)))
    x[2] = 0.0
    assert torch.equal(hybrid.decode(hybrid.encode(x), n, torch.float32),
                       inner.decode(inner.encode(x), n, torch.float32))
    s_h = hybrid.decode_sum_wire(hybrid.encode_wire(x), n, torch.float32)
    s_i = inner.decode_sum_wire(inner.encode_wire(x), n, torch.float32)
    assert torch.equal(s_h, s_i)
    assert torch.equal(
        hybrid.decode_wire(hybrid.encode_wire(x), n, torch.bfloat16),
        inner.decode_wire(inner.encode_wire(x), n, torch.bfloat16))


@pytest.mark.parametrize("base", BASES)
def test_zle_hop_equals_inner_hop_bitwise(base, rng):
    """Through the transport (one process): the stack's all-gather,
    reduce-scatter and all-reduce equal the inner codec's, packed and
    multibuffer, monolithic and ring."""
    head, sep, rest = base.partition(":")
    for ring in ("", ":chunks=4"):
        hybrid = treg.codec_from_spec(f"{head}+zle{sep}{rest}{ring}")
        inner = hybrid.inner
        x = torch.from_numpy(tp_like(rng, (4, 3 * hybrid.granule)))
        for fn in (cc.all_gather_c, cc.psum_scatter_c):
            want = fn(x, None, 1, inner, inner)
            assert torch.equal(fn(x, None, 1, hybrid, hybrid), want)
            with cc.multibuffer_wire():
                assert torch.equal(fn(x, None, 1, hybrid, hybrid), want)
        assert torch.equal(cc.allreduce_g(x, None, hybrid, hybrid),
                           cc.allreduce_g(x, None, inner, inner))


def test_zlecodec_wire_smaller_on_zeros_and_bounded_expansion():
    hybrid = treg.codec_from_spec("taco+zle")
    n = 4 * hybrid.granule
    lay = hybrid.wire_layout(n)
    ach = tcodecs.achieved_wire_bytes(
        hybrid.encode_wire(torch.zeros((1, n))), lay)
    assert int(ach[0]) < lay.total_bytes
    inner_bytes = hybrid.inner.wire_layout(n).total_bytes
    assert lay.total_bytes == inner_bytes + hybrid.expansion_bytes(n)
    j = jreg.codec_from_spec("taco+zle:jnp")
    assert hybrid.expansion_bytes(n) == j.expansion_bytes(n)
    assert hybrid.bytes_per_element() == j.bytes_per_element()
    assert hybrid.bytes_per_element() > hybrid.inner.bytes_per_element()


def test_zlecodec_is_frozen_and_hashable():
    a = treg.codec_from_spec("taco+zle")
    b = treg.codec_from_spec("taco+zle")
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.inner = None


def test_stage_registry_lists_zle():
    assert treg.list_stages() == jreg.list_stages() == ["zle"]
    for bad in ("none+zle", "taco+nosuch"):
        with pytest.raises(treg.CommSpecError):
            treg.codec_from_spec(bad)
        with pytest.raises(jreg.CommSpecError):
            jreg.codec_from_spec(bad)


@pytest.mark.parametrize("spec", ["taco+zle", "taco+zle:folded:chunks=4",
                                  "sdp4bit+zle:g=4", "tahquant+zle",
                                  "int8+zle:g=64"])
def test_achieved_probe_ratio_matches_jax(spec):
    port = treg.codec_from_spec(spec)
    want = jtel.achieved_probe_ratio(jreg.codec_from_spec(_jax_spec(spec)))
    got = ttel.achieved_probe_ratio(port)
    assert 0.0 < got <= 1.0 and got == want
    assert ttel.achieved_probe_ratio(port) == got          # cached
    ttel.clear_probe_cache()
    assert ttel.achieved_probe_ratio(port) == got


def test_zle_group_spec_roundtrip_and_validation():
    c = treg.codec_from_spec("taco+zle:g=32")
    assert treg.codec_to_spec(c) == "taco+zle:g=32"
    assert treg.codec_from_spec(treg.codec_to_spec(c)) == c
    base_g = treg.codec_from_spec("taco+zle:g64")  # binds to taco's group
    assert base_g.group == TL.GROUP_BYTES
    assert base_g.inner.cfg.quant_group_size == 64
    for bad in ("taco+zle:g=0", "taco+zle:g=16:g=32", "taco:g=16"):
        with pytest.raises(treg.CommSpecError):
            treg.codec_from_spec(bad)
