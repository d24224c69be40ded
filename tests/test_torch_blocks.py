"""The port's block operators (K1 compress_blocks, K3 decompress_blocks, K4
decompress_reduce), the route between block and wire forms, and the
collectives' autograd pairs, held against the JAX package.

K1, K3 and K4 run their plain versions here (CPU tensors); the JAX side is
the Pallas kernel in interpret mode.  Tolerances are the JAX package's own
kernel-vs-oracle ones (``tests/test_kernels.py``): rtol 1e-5 on alpha and
s, rtol 1e-4 / atol 1e-5 on decoded values, and payloads differing in
under 1% of the values (the packages sum the f32 rotation in different
orders: a value on a rounding boundary lands one code apart, and in e5m2
a rotated value that cancels to near 0 can take either sign; a few
hundred bytes are too few for the 1e-4 fraction of
``ref.check_wire_parity``).

The inputs come from this module's own generator, so the draws of the
session-wide ``rng`` fixture that other files see do not depend on it.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core.registry import codec_from_spec as jspec
from repro.kernels import ash_compress as jk1
from repro.kernels import ash_decompress as jk34
from repro.kernels import ops as jops
from repro_torch.core import collectives as cc
from repro_torch.core.codecs import pack_wire, unpack_wire
from repro_torch.core.registry import codec_from_spec
from repro_torch.kernels import ash_compress, ash_decompress, ops, ref

SPECS = ["taco", "taco:folded", "taco:g64", "taco:int8", "taco:e5m2",
         "taco:folded:g32"]


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def jcfg(spec):
    return jspec(spec.replace("taco", "taco:pallas_interpret", 1)).cfg


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows", [1, 7, 128, 300])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_compress_blocks_plain_matches_interpret_kernel(spec, rows, in_dtype,
                                                        rng):
    cfg = codec_from_spec(spec).cfg
    x = tp_like(rng, (rows, 256))
    qj, aj, sj = jk1.compress_blocks_pallas(
        jnp.asarray(x).astype(getattr(jnp, in_dtype)), jcfg(spec),
        interpret=True)
    xt = t(x).to(getattr(torch, in_dtype))
    before = ash_compress.compress_blocks.launches
    qt, at, st = ash_compress.compress_blocks(xt, cfg)
    assert ash_compress.compress_blocks.launches == before   # plain version
    assert qt.dtype == cfg.format_spec.dtype and qt.shape == (rows, 256)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    mism = np.mean(qt.float().numpy() != np.asarray(qj.astype(jnp.float32)))
    assert mism < 0.01, f"payload mismatch fraction {mism}"


@pytest.mark.parametrize("spec", ["taco", "taco:folded", "taco:int8",
                                  "taco:g64"])
@pytest.mark.parametrize("rows", [1, 130])
def test_decompress_blocks_plain_matches_interpret_kernel(spec, rows, rng):
    cfg, jc = codec_from_spec(spec).cfg, jcfg(spec)
    x = jnp.asarray(tp_like(rng, (rows, 256)))
    q, a, s = jk1.compress_blocks_pallas(x, jc, interpret=True)
    if cfg.metadata == "folded":
        s, a = s / a[:, None], None
    want = jk34.decompress_blocks_pallas(q, s, a, jc, interpret=True)
    qt = t(np.asarray(q).view(np.uint8)).view(cfg.format_spec.dtype)
    got = ash_decompress.decompress_blocks(qt, t(s), None if a is None
                                           else t(a), cfg)
    assert got.dtype == torch.float32
    ref.check_decoded_close(got, t(want))


@pytest.mark.parametrize("spec", ["taco", "taco:folded", "taco:g64"])
@pytest.mark.parametrize("peers", [1, 2, 4])
def test_decompress_reduce_plain_matches_interpret_kernel(spec, peers, rng):
    cfg, jc = codec_from_spec(spec).cfg, jcfg(spec)
    qs, ss, aas = [], [], []
    for _ in range(peers):
        q, a, s = jk1.compress_blocks_pallas(
            jnp.asarray(tp_like(rng, (130, 256))), jc, interpret=True)
        qs.append(q), ss.append(s), aas.append(a)
    q, s, a = jnp.stack(qs), jnp.stack(ss), jnp.stack(aas)
    if cfg.metadata == "folded":
        s, a = s / a[..., None], None
    want = jk34.decompress_reduce_pallas(q, s, a, jc, interpret=True)
    qt = t(np.asarray(q).view(np.uint8)).view(cfg.format_spec.dtype)
    got = ash_decompress.decompress_reduce(qt, t(s), None if a is None
                                           else t(a), cfg)
    assert got.shape == (130, 256)
    ref.check_decoded_close(got, t(want))


# --------------------------------------------------------------------------
# the route between the wire forms and the block forms
# --------------------------------------------------------------------------

def test_wire_budget_matches_the_reference():
    assert ops.WIRE_FUSED_MAX_SLOT_ELEMS == jops.WIRE_FUSED_MAX_SLOT_ELEMS
    cfg, jc = codec_from_spec("taco").cfg, jspec("taco:pallas").cfg
    budget = ops.WIRE_FUSED_MAX_SLOT_ELEMS
    for n in (None, 256, 3584, budget, budget + 256, 7_340_032):
        assert (ops.wire_kernel_impl(cfg, n) is None) == \
            (jops.wire_kernel_impl(jc, n) is None), n
    # the reference gates the peer-stacked reduce on P*n
    for peers, n in ((1, budget), (2, budget // 2), (4, budget // 2)):
        assert (ops.wire_kernel_impl(cfg, peers * n) is None) == \
            (jops.wire_kernel_impl(jc, peers * n) is None)
    # configurations outside the kernels' coverage never take the wire form
    for spec in ("taco:hadamard", "taco:tensorscale"):
        assert ops.wire_kernel_impl(codec_from_spec(spec).cfg, 256) is None


class Spy:
    """Counts the calls of the ops-level operators a codec reaches."""

    NAMES = ("compress_blocks", "decompress_blocks", "decompress_reduce",
             "compress_wire", "decompress_wire", "decompress_reduce_wire")

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            inner = getattr(ops, name)

            def spy(*a, _inner=inner, _name=name, **k):
                self.calls[_name] += 1
                return _inner(*a, **k)
            monkeypatch.setattr(ops, name, spy)

    def used(self):
        return {k for k, v in self.calls.items() if v}


def test_codec_routes_by_slot_size(monkeypatch):
    codec = codec_from_spec("taco")
    budget = ops.WIRE_FUSED_MAX_SLOT_ELEMS
    spy = Spy(monkeypatch)
    x = torch.zeros((1, budget))
    w = codec.encode_wire(x)
    codec.decode_wire(w, budget, torch.float32)
    codec.decode_sum_wire(w, budget, torch.float32)
    assert spy.used() == {"compress_wire", "decompress_wire",
                          "decompress_reduce_wire"}
    # a 2-peer stack of slots inside the budget is reduced by the block
    # form when P*n (here budget + 512) is above it
    n2 = budget // 2 + 256
    w2 = codec.encode_wire(torch.zeros((2, n2)))
    spy = Spy(monkeypatch)
    codec.decode_sum_wire(w2, n2, torch.float32)
    assert spy.used() == {"decompress_reduce"}
    # one block more than the budget takes the block forms
    x = torch.zeros((1, budget + 256))
    w = codec.encode_wire(x)
    codec.decode_wire(w, budget + 256, torch.float32)
    assert spy.used() == {"compress_blocks", "decompress_blocks",
                          "decompress_reduce"}


@pytest.mark.parametrize("spec", SPECS)
def test_block_route_equals_wire_route_on_cpu(spec, monkeypatch, rng):
    """Both routes run the plain versions here: identical bytes and
    identical decoded values (the block forms' parity on the card is
    chip_smoke.py's and test_torch_gpu.py's)."""
    codec = codec_from_spec(spec)
    n = 1024
    x = t(tp_like(rng, (3, n))).to(torch.bfloat16)
    wire = codec.encode_wire(x)
    dec = codec.decode_wire(wire, n, torch.float32)
    red = codec.decode_sum_wire(wire, n, torch.float32)
    monkeypatch.setattr(ops, "WIRE_FUSED_MAX_SLOT_ELEMS", 0)
    spy = Spy(monkeypatch)
    wire_b = codec.encode_wire(x)
    assert torch.equal(wire_b, wire)
    assert torch.equal(codec.decode_wire(wire, n, torch.float32), dec)
    assert torch.equal(codec.decode_sum_wire(wire, n, torch.float32), red)
    assert spy.used() == {"compress_blocks", "decompress_blocks",
                          "decompress_reduce"}
    # and the block route is pack/unpack over encode/decode by definition
    layout = codec.wire_layout(n)
    assert torch.equal(wire_b, pack_wire(codec.encode(x), layout))
    assert torch.equal(codec.decode(unpack_wire(wire, layout), n,
                                    torch.float32), dec)


# --------------------------------------------------------------------------
# the collectives' autograd pairs (group of one; both routes)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 0], ids=["wire", "blocks"])
def test_conjugate_pairs_swap_codecs(budget, monkeypatch, rng):
    if budget is not None:
        monkeypatch.setattr(ops, "WIRE_FUSED_MAX_SLOT_ELEMS", budget)
    fc, bc = codec_from_spec("taco:folded"), codec_from_spec("taco")
    x = t(tp_like(rng, (2, 8, 128))).to(torch.bfloat16)
    ct = t(tp_like(rng, (2, 8, 128))).to(torch.bfloat16)

    def vjp(fn):
        xx = x.clone().requires_grad_(True)
        y = fn(xx)
        y.backward(ct)
        return y.detach(), xx.grad

    y, g = vjp(lambda a: cc.all_gather_c(a, 1, 1, fc, bc))
    assert torch.equal(y, cc.all_gather_c(x, 1, 1, fc, bc))
    assert torch.equal(g, cc.psum_scatter_c(ct, 1, 1, bc, fc))
    y, g = vjp(lambda a: cc.psum_scatter_c(a, 1, 1, fc, bc))
    assert torch.equal(y, cc._rs_impl(x, 1, 1, fc))
    assert torch.equal(g, cc.all_gather_c(ct, 1, 1, bc, fc))
    y, g = vjp(lambda a: cc.copy_f(a, 1, fc, bc))
    assert torch.equal(y, x)
    assert torch.equal(g, cc._ar_impl(ct, 1, bc))
    y, g = vjp(lambda a: cc.allreduce_g(a, 1, fc, bc))
    assert torch.equal(y, cc._ar_impl(x, 1, fc))
    assert torch.equal(g, ct)
    y, g = vjp(lambda a: cc.psum_exact(a, 1))
    assert torch.equal(y, x) and torch.equal(g, ct)
    # the compressed hops really compress: they are not the identity
    assert not torch.equal(cc.all_gather_c(x, 1, 1, fc, bc), x)


def test_sp_pair_of_a_group_larger_than_one_raises():
    """A group larger than one moves through a torch.distributed process
    group (tests/test_torch_dist.py); a bare size names no group."""
    x = torch.zeros(1, 4, 256, dtype=torch.bfloat16, requires_grad=True)
    for codec in (codec_from_spec("taco"), codec_from_spec("none")):
        with pytest.raises(ValueError, match="process group"):
            cc.all_gather_c(x, 2, 1, codec, codec)
        with pytest.raises(ValueError, match="process group"):
            cc.psum_scatter_c(x, 2, 1, codec, codec)
