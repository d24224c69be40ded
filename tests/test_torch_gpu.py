"""Kernel-vs-plain tests on the card (marker ``gpu``; they skip without
one).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The six CUDA kernels are held against their plain PyTorch versions on the
same inputs: K1 and K2 bit for bit at an f32 compute dtype (they round in
the plain version's order, ``ref.plain_bits``), the rest with the parity
rule of ``repro_torch.kernels.ref``; each block form against its wire
form bit for bit (they share one per-row body); K3 against K4 on one peer
bit for bit under folded f32 metadata; K5 and K6 on wire views at byte
offsets 1-3 against the aligned wire bit for bit; the card's taco decode
and taco train step against the CPU's (plain versions).
"""
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro_torch.core.codecs import pack_wire, unpack_wire
from repro_torch.core.registry import codec_from_spec
from repro_torch.kernels import ash_compress, ash_decompress, ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    """Decided when a test runs, never at import (xdist workers must
    collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("spec", ["taco", "taco:folded", "taco:e5m2",
                                  "taco:int8", "taco:g64",
                                  "taco:folded:g32", "taco:seps1e-20"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("peers,n", [(3, 3584), (4, 3584), (2, 256 * 97)])
def test_wire_kernels_match_plain(card, spec, in_dtype, peers, n, rng):
    """K2 gives the plain version's wire byte for byte; K5 and K6 within the
    decode tolerance (chip_smoke.py holds the serve shape itself,
    slots=1)."""
    cfg = codec_from_spec(spec).cfg
    x = torch.from_numpy(tp_like(rng, (peers, n))).to(card, in_dtype)
    wire = ash_compress.compress_wire(x, cfg)
    assert ref.check_compress_wire(wire, ref.compress_wire_ref(x, cfg), n,
                                   cfg)["bitwise"]
    ref.check_decoded_close(ash_decompress.decompress_wire(wire, n, cfg),
                            ref.decompress_wire_ref(wire, n, cfg))
    ref.check_decoded_close(
        ash_decompress.decompress_reduce_wire(wire, n, cfg),
        ref.decompress_reduce_wire_ref(wire, n, cfg))


def test_degenerate_blocks_match_plain(card):
    cfg = codec_from_spec("taco:seps1e-20").cfg
    x = torch.zeros((2, 768), device=card)
    x[1, 256:512] = 1e-38
    wire = ash_compress.compress_wire(x, cfg)
    assert ref.check_compress_wire(wire, ref.compress_wire_ref(x, cfg), 768,
                                   cfg)["bitwise"]
    out = ash_decompress.decompress_wire(wire, 768, cfg)
    assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0


def test_each_launch_counts_once(card):
    cfg = codec_from_spec("taco").cfg
    x = torch.zeros((1, 512), device=card)
    counters = (ash_compress.compress_wire, ash_decompress.decompress_wire,
                ash_decompress.decompress_reduce_wire)
    before = [c.launches for c in counters]
    wire = ash_compress.compress_wire(x, cfg)
    ash_decompress.decompress_wire(wire, 512, cfg)
    ash_decompress.decompress_reduce_wire(wire, 512, cfg)
    ref.compress_wire_ref(x, cfg)               # plain versions: no count
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]


def test_decode_on_card_matches_cpu(card):
    """Smoke qwen2-0.5b under taco: logits on the card (kernels) against
    the CPU (plain versions), same weights and tokens; 5e-2 as in
    tests/test_torch_model.py."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    from repro_torch.serve import serve_step as ss
    cfg = smoke_config(get_config("qwen2-0.5b"))
    plan = make_plan(cfg, 1, 1, remat=False)
    ctx = ParallelCtx(plan=from_spec("taco"))
    cpu, gpu = Model(cfg, plan, device="cpu"), Model(cfg, plan)
    p_cpu = cpu.init(0)
    p_gpu = tree_map(lambda a: a.to(card), p_cpu)
    c_cpu, c_gpu = ss.init_cache(cpu, 3, 16), ss.init_cache(gpu, 3, 16)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 6)))
    before = ash_compress.compress_wire.launches
    for t in range(6):
        _, lc = ss.decode_forward(p_cpu, toks[:, t:t + 1], c_cpu, t, cpu, ctx,
                                  return_logits=True)
        _, lg = ss.decode_forward(p_gpu, toks[:, t:t + 1].to(card), c_gpu, t,
                                  gpu, ctx, return_logits=True)
        lg = lg.cpu()
        assert torch.isfinite(lg).all()
        assert float((lg - lc).norm() / lc.norm()) < 5e-2
    assert ash_compress.compress_wire.launches - before == \
        6 * 2 * (2 * cfg.n_layers + 1)


BLOCK_SPECS = ["taco", "taco:folded", "taco:e5m2", "taco:int8", "taco:g64",
               "taco:folded:g32", "taco:seps1e-20"]


@pytest.mark.parametrize("spec", BLOCK_SPECS)
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [40, 28 * 97])
def test_block_kernels_match_plain(card, spec, in_dtype, rows, rng):
    """K1 gives the plain version's q, alpha and s bit for bit; K3 and K4
    within the decode tolerance."""
    cfg = codec_from_spec(spec).cfg
    x = torch.from_numpy(tp_like(rng, (rows, 256))).to(card, in_dtype)
    q, a, s = ash_compress.compress_blocks(x, cfg)
    qp, ap, sp = ref.compress_blocks_ref(x, cfg)
    _assert_same_bits((q, a, s), (qp, ap, sp))
    layout = ref._layout(cfg, rows * 256)

    def row(q_, a_, s_):
        from repro_torch.core import taco
        pay = taco._storage_to_wire(q_, cfg.format_spec).reshape(1, -1)
        if cfg.metadata == "folded":
            return pack_wire((pay, (s_ / a_[:, None]).reshape(1, -1)), layout)
        return pack_wire((pay, s_.reshape(1, -1), a_.reshape(1, -1)), layout)
    assert ref.check_compress_wire(row(q, a, s), row(qp, ap, sp), rows * 256,
                                   cfg)["bitwise"]
    alpha = None if cfg.metadata == "folded" else ap
    scale = sp / ap[:, None] if alpha is None else sp
    ref.check_decoded_close(
        ash_decompress.decompress_blocks(qp, scale, alpha, cfg),
        ref.decompress_blocks_ref(qp, scale, alpha, cfg))
    peers = 4
    qs = qp.reshape(peers, rows // peers, 256) if rows % peers == 0 else \
        qp[None]
    p_ = qs.shape[0]
    ss = scale.reshape(p_, -1, scale.shape[-1])
    al = None if alpha is None else alpha.reshape(p_, -1)
    ref.check_decoded_close(ash_decompress.decompress_reduce(qs, ss, al, cfg),
                            ref.decompress_reduce_ref(qs, ss, al, cfg))


@pytest.mark.parametrize("spec", BLOCK_SPECS)
@pytest.mark.parametrize("peers", [1, 4])
def test_block_forms_equal_wire_forms_bitwise(card, spec, peers, rng):
    """pack_wire(K1(x)) == K2(x); K3(unpack_wire(w)) == K5(w);
    K4(unpack_wire(w)) == K6(w) — one shared per-row body each."""
    codec = codec_from_spec(spec)
    n = 256 * 97
    x = torch.from_numpy(tp_like(rng, (peers, n))).to(card, torch.bfloat16)
    wire = ops.compress_wire(x, codec.cfg)
    layout = codec.wire_layout(n)
    assert torch.equal(pack_wire(codec.encode(x), layout), wire)
    enc = unpack_wire(wire, layout)
    assert torch.equal(codec.decode(enc, n, torch.float32),
                       ops.decompress_wire(wire, n, codec.cfg))
    assert torch.equal(codec.decode_sum(enc, n, torch.float32),
                       ops.decompress_reduce_wire(wire, n, codec.cfg)
                       .reshape(-1))


def test_block_launches_count_once(card):
    cfg = codec_from_spec("taco").cfg
    counters = (ash_compress.compress_blocks,
                ash_decompress.decompress_blocks,
                ash_decompress.decompress_reduce)
    before = [c.launches for c in counters]
    q, a, s = ash_compress.compress_blocks(torch.zeros((2, 256),
                                                       device=card), cfg)
    ash_decompress.decompress_blocks(q, s, a, cfg)
    ash_decompress.decompress_reduce(q[None], s[None], a[None], cfg)
    ref.compress_blocks_ref(torch.zeros((2, 256), device=card), cfg)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]


@pytest.mark.parametrize("budget", [None, 0], ids=["wire", "blocks"])
def test_train_step_on_card_matches_cpu(card, budget, monkeypatch):
    """Smoke qwen2-0.5b, one taco train step: loss and grad norm on the
    card (kernels) against the CPU (plain versions), same weights and
    batch; 1e-3 on the loss and 5e-2 on the grad norm, the bounds of
    tests/test_torch_train.py (the card's bf16 matmuls round differently
    from the CPU's)."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    if budget is not None:
        monkeypatch.setattr(ops, "WIRE_FUSED_MAX_SLOT_ELEMS", budget)
    cfg = smoke_config(get_config("qwen2-0.5b"))
    plan = make_plan(cfg, 1, 1)
    ctx = ParallelCtx(plan=from_spec("taco"))
    oc = adamw.OptConfig(lr_max=1e-3, warmup_steps=2, total_steps=10)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 2)).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, plan, device=dev)
        params = model.init(0) if dev == "cpu" else \
            tree_map(lambda a: a.to(card), out["cpu"][0])
        if dev == "cpu":
            init = tree_map(lambda a: a.clone(), params)
        step = build_train_step(model, ctx, oc)
        counts = [k.launches for k in (ash_compress.compress_blocks,
                                       ash_compress.compress_wire)]
        _, _, m = step(params, adamw.init_opt_state(params),
                       SyntheticLM.place(batch, model.device))
        out[dev] = (init if dev == "cpu" else None, float(m["loss"]),
                    float(m["grad_norm"]),
                    [k.launches - c for k, c in zip(
                        (ash_compress.compress_blocks,
                         ash_compress.compress_wire), counts)])
    _, lc, gc, _ = out["cpu"]
    _, lg, gg, launched = out["cuda"]
    assert abs(lg - lc) / lc < 1e-3
    assert abs(gg - gc) / gc < 5e-2
    assert launched[0 if budget == 0 else 1] > 0
    assert launched[1 if budget == 0 else 0] == 0


@pytest.mark.parametrize("fmt", ["e4m3", "int8"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [32, 64, 128, 256, 512])
def test_butterfly_kernel_matches_plain(card, b, in_dtype, fmt, rng):
    """K7 against its plain version: alpha and s within the parity rule's
    metadata tolerance, the payload under its flip rule (each case
    compares more than 1e4 bytes)."""
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import fwht_butterfly
    cfg = TacoConfig(block_size=b, fmt=fmt)
    rows = 40 * 1024 // b
    x = torch.from_numpy(tp_like(rng, (rows, b))).to(card, in_dtype)
    before = fwht_butterfly.compress_blocks_butterfly.launches
    q, a, s = fwht_butterfly.compress_blocks_butterfly(x, cfg)
    assert fwht_butterfly.compress_blocks_butterfly.launches == before + 1
    qp, ap, sp = ref.compress_blocks_butterfly_ref(x, cfg)
    torch.cuda.synchronize()
    assert s.shape == (rows, 1) and q.dtype == qp.dtype
    ref.check_wire_parity(ref.blocks_to_wire(q, a, s, cfg, 1, rows * b),
                          ref.blocks_to_wire(qp, ap, sp, cfg, 1, rows * b),
                          rows * b, cfg)


def _bits(t):
    """A tensor's bits, for equality that tells -0 from +0."""
    return t.view(torch.uint8) if t.element_size() == 1 else \
        t.view(torch.int32)


def _butterfly_ragged_rows(b, dtype):
    """Row counts around the launch geometry's edges at width ``b``: 1 row,
    one less and one more than a warp's and a block's rows, a partial last
    block, and two passes of the persistent grid plus a ragged tail."""
    from repro_torch.kernels import fwht_butterfly as fb
    geo = fb.geometry(b, dtype, 1, fb._sms(torch.cuda.current_device()))
    rw, rb = geo.rows_per_warp, geo.rows_per_block
    sms = fb._sms(torch.cuda.current_device())
    full = fb.geometry(b, dtype, 1 << 30, sms).grid * rb
    return sorted({1, max(1, rw - 1), rw + 1, rb - 1, rb + 1, 3 * rb + 5,
                   2 * full + rw + 3})


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [32, 64, 128, 256, 512])
def test_butterfly_ragged_row_counts(card, b, in_dtype, fmt, rng):
    """K7 at ragged row counts (``_butterfly_ragged_rows``), one launch
    each: all of them together against the plain version under the parity
    rule (the small counts alone compare too few bytes for its flip
    allowance), and each bit for bit against the same rows of one launch
    on the largest count (a ragged warp masks its stores and nothing
    else)."""
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import fwht_butterfly
    cfg = TacoConfig(block_size=b, fmt=fmt)
    counts = _butterfly_ragged_rows(b, in_dtype)
    x = torch.from_numpy(tp_like(rng, (counts[-1], b))).to(card, in_dtype)
    whole = fwht_butterfly.compress_blocks_butterfly(x, cfg)
    got, want = [], []
    for r in counts:
        before = fwht_butterfly.compress_blocks_butterfly.launches
        out = fwht_butterfly.compress_blocks_butterfly(x[:r], cfg)
        assert fwht_butterfly.compress_blocks_butterfly.launches == before + 1
        for o, w in zip(out, whole):
            assert torch.equal(_bits(o), _bits(w[:r])), r
        got.append(out)
        want.append(ref.compress_blocks_butterfly_ref(x[:r], cfg))
    torch.cuda.synchronize()
    rows = sum(counts)
    cat = [torch.cat([o[i] for o in got]) for i in range(3)]
    cat_p = [torch.cat([o[i] for o in want]) for i in range(3)]
    ref.check_wire_parity(ref.blocks_to_wire(*cat, cfg, 1, rows * b),
                          ref.blocks_to_wire(*cat_p, cfg, 1, rows * b),
                          rows * b, cfg)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [32, 64, 128, 256, 512])
def test_butterfly_rows_are_independent(card, b, in_dtype, fmt, rng):
    """Row i of K7's output is the same bits whether the row is computed
    with its neighbours, in a slice that starts elsewhere (another warp,
    segment and block), or among the rows shuffled."""
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import fwht_butterfly
    cfg = TacoConfig(block_size=b, fmt=fmt)
    rows = 3 * fwht_butterfly.geometry(b, in_dtype, 1, 1).rows_per_block + 7
    x = torch.from_numpy(tp_like(rng, (rows, b))).to(card, in_dtype)
    whole = [_bits(o)
             for o in fwht_butterfly.compress_blocks_butterfly(x, cfg)]
    for lo, hi in ((5, rows), (1, rows - 3), (17, 18)):
        part = fwht_butterfly.compress_blocks_butterfly(x[lo:hi], cfg)
        for o, w in zip(part, whole):
            assert torch.equal(_bits(o), w[lo:hi]), (lo, hi)
    perm = torch.from_numpy(rng.permutation(rows)).to(card)
    shuf = fwht_butterfly.compress_blocks_butterfly(x[perm].contiguous(), cfg)
    for o, w in zip(shuf, whole):
        assert torch.equal(_bits(o), w[perm])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [32, 64, 128, 256, 512])
def test_butterfly_kernel_equals_plain_bit_for_bit(card, b, in_dtype, fmt,
                                                   rng):
    """K7 rounds every product and sum once, in its plain version's order
    (the pairwise sum of squares, ``ash.fwht``'s stages, true divisions),
    so its codes, alpha and s are the plain version's bits on the card."""
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import fwht_butterfly
    cfg = TacoConfig(block_size=b, fmt=fmt)
    x = torch.from_numpy(tp_like(rng, (256 * 1024 // b, b))).to(card,
                                                                in_dtype)
    x[3] = 0
    got = fwht_butterfly.compress_blocks_butterfly(x, cfg)
    want = ref.compress_blocks_butterfly_ref(x, cfg)
    for o, w in zip(got, want):
        assert torch.equal(_bits(o), _bits(w))


def test_butterfly_refuses_what_the_kernel_does_not_take(card):
    """A CUDA input that is unaligned, not contiguous, of another width or
    dtype raises and launches nothing."""
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import fwht_butterfly
    cfg = TacoConfig()
    flat = torch.zeros(8 * 256 + 8, device=card)
    wide = torch.zeros((8, 512), device=card)
    before = fwht_butterfly.compress_blocks_butterfly.launches
    for bad in (flat[1:1 + 8 * 256].view(8, 256), wide[:, :256],
                torch.zeros((8, 1024), device=card),
                torch.zeros((8, 256), device=card, dtype=torch.float16),
                torch.zeros(256, device=card)):
        with pytest.raises(ValueError):
            fwht_butterfly.compress_blocks_butterfly(bad, cfg)
    assert fwht_butterfly.compress_blocks_butterfly.launches == before


@pytest.mark.parametrize("budget", [None, 0], ids=["wire", "blocks"])
def test_nccl_ring_equals_monolithic(card, budget, tmp_path, monkeypatch,
                                     rng):
    """A 1-rank NCCL group on the card: the monolithic hops move the wire
    through NCCL; the ring (chunks 4, both schedules) equals them bit for
    bit, forward and backward."""
    import torch.distributed as dist

    from repro_torch.core import collectives as cc
    from repro_torch.core.parallel import init_tp_group
    if budget is not None:
        monkeypatch.setattr(ops, "WIRE_FUSED_MAX_SLOT_ELEMS", budget)
    group = init_tp_group("cuda", init_method=f"file://{tmp_path}/store",
                          world_size=1, rank=0, timeout_s=60)
    try:
        x = torch.from_numpy(tp_like(rng, (2, 48, 128))).to(card,
                                                            torch.bfloat16)
        ct = torch.from_numpy(tp_like(rng, (2, 48, 128))).to(card,
                                                             torch.bfloat16)

        def hops(spec):
            c = codec_from_spec(spec)
            out = []
            for fn in (cc.all_gather_c, cc.psum_scatter_c):
                xx = x.clone().requires_grad_(True)
                y = fn(xx, group, 1, c, c)
                y.backward(ct)
                out += [y.detach(), xx.grad]
            out.append(cc.allreduce_g(x, group, c, c))
            return out
        mono = hops("taco:folded")
        assert not torch.equal(mono[0], x)          # the codec ran
        for spec in ("taco:folded:chunks=4",
                     "taco:folded:chunks=4:schedule=serial"):
            for got, want in zip(hops(spec), mono):
                assert torch.equal(got, want), spec
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# K1 and K2: one shared row body
# --------------------------------------------------------------------------

def _assert_same_bits(got, want):
    """Block-form arrays (q, alpha, s) equal bit for bit (-0 apart from
    +0)."""
    for name, g, w in zip(("q", "alpha", "s"), got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w)), name


def _k1_k2(x, codec, slots, n):
    """K1 on the blocks of ``x`` (slots, n) and K2 on ``x``: returns K2's
    wire, K1's packed wire and the plain version's wire.  Where
    ``ref.plain_bits`` holds, K1's q, alpha and s are the plain version's
    bit for bit."""
    cfg = codec.cfg
    blocks = x.reshape(-1, cfg.block_size)
    q, a, s = ash_compress.compress_blocks(blocks, cfg)
    if ref.plain_bits(cfg):
        _assert_same_bits((q, a, s), ref.compress_blocks_ref(blocks, cfg))
    k1 = ref.blocks_to_wire(q, a, s, cfg, slots, n)
    k2 = ash_compress.compress_wire(x, cfg)
    return k2, k1, ref.compress_wire_ref(x, cfg)


@pytest.mark.parametrize("metadata", ["", ":folded"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("gs", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_compress_kernels_every_group_size(card, gs, fmt, metadata, rng):
    """Every group size the registry's ``g<k>`` takes (one group per lane
    element up to one per row), every format, both metadata layouts (64
    rows): K2, pack(K1) and the plain version's wire equal bit for bit, and
    K1's q, alpha and s the plain version's."""
    codec = codec_from_spec(f"taco:{fmt}:g{gs}{metadata}")
    n = 256 * 64
    x = torch.from_numpy(tp_like(rng, (1, n))).to(card, torch.bfloat16)
    k2, k1, plain = _k1_k2(x, codec, 1, n)
    assert torch.equal(k1, k2)
    assert ref.check_compress_wire(k2, plain, n, codec.cfg)["bitwise"]


def planted(gen, rows, b):
    """f32 rows z @ H / sqrt(B) of seeded normal z with one aligned group of
    8 values of z per row at 0: the rotation cancels there, so only the
    plain version's order gives its codes (also
    tests/test_torch_compress_order.py)."""
    from repro_torch.core.ash import hadamard_matrix
    z = gen.normal(size=(rows, b))
    start = 8 * gen.integers(0, b // 8, size=rows)
    z[np.arange(rows)[:, None], start[:, None] + np.arange(8)] = 0.0
    h = hadamard_matrix(b, torch.float64).numpy()
    return torch.from_numpy((z @ h).astype(np.float32))


@pytest.mark.parametrize("metadata", ["", ":folded"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("gs", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_compress_kernels_planted_rows(card, gs, fmt, metadata):
    """Rows with a rotated group planted at 0 (64 rows), every format and
    group size, both layouts: K2, pack(K1) and the plain version's wire
    equal bit for bit, and the plain version on the card equals the plain
    version on the CPU (its own generator: the tests above draw as
    before)."""
    codec = codec_from_spec(f"taco:{fmt}:g{gs}{metadata}")
    n = 256 * 64
    x = planted(np.random.default_rng(29 + gs), 64, 256).reshape(1, n)
    k2, k1, plain = _k1_k2(x.to(card), codec, 1, n)
    assert torch.equal(k1, k2)
    assert ref.check_compress_wire(k2, plain, n, codec.cfg)["bitwise"]
    assert torch.equal(plain.cpu(), ref.compress_wire_ref(x, codec.cfg))


@pytest.mark.parametrize("spec", ["taco", "taco:folded", "taco:folded:g32",
                                  "taco:int8:g128"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
def test_compress_wire_rows_at_4_byte_offsets(card, spec, in_dtype, rng):
    """n = 1792 (7 rows) under folded metadata gives total = 1820 = 4 mod 8
    (dual int8:g128: 1876),
    so every odd slot's payload starts 4-byte aligned only; 9 slots, 16128
    payload bytes, and 7 rows per slot (a ragged count for 8-row blocks)."""
    codec = codec_from_spec(spec)
    slots, n = 9, 1792
    x = torch.from_numpy(tp_like(rng, (slots, n))).to(card, in_dtype)
    k2, k1, plain = _k1_k2(x, codec, slots, n)
    if spec in ("taco:folded", "taco:int8:g128"):     # mb G (+ mb) odd
        assert k2.shape[1] % 8 == 4
    assert torch.equal(k1, k2)
    assert ref.check_compress_wire(k2, plain, n, codec.cfg)["bitwise"]


@pytest.mark.parametrize("rows", [1, 7, 9, 14, 4099])
def test_compress_blocks_ragged_row_counts(card, rows, rng):
    """Row counts that are not a multiple of a block's 8 warps: the warps
    past the last row return, the rows before it are all written (the
    plain version's bits)."""
    codec = codec_from_spec("taco")
    x = torch.from_numpy(tp_like(rng, (1, rows * 256))).to(card,
                                                          torch.bfloat16)
    k2, k1, plain = _k1_k2(x, codec, 1, rows * 256)
    assert torch.equal(k1, k2)
    assert ref.check_compress_wire(k2, plain, rows * 256, codec.cfg)[
        "bitwise"]


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_compress_kernels_on_unaligned_views(card, in_dtype, offset, rng):
    """A contiguous view whose first element is not 16-byte aligned takes
    the scalar loads: the same bytes as the aligned copy, bit for bit."""
    codec = codec_from_spec("taco:g64")
    n = 256 * 40
    base = torch.from_numpy(tp_like(rng, (n + offset,))).to(card, in_dtype)
    view = base[offset:].view(1, n)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    aligned = view.clone()
    assert aligned.data_ptr() % 16 == 0
    for fn in (lambda t: ash_compress.compress_wire(t, codec.cfg),
               lambda t: torch.cat([
                   a.reshape(-1).view(torch.uint8) for a in
                   ash_compress.compress_blocks(t.reshape(-1, 256),
                                                codec.cfg)])):
        assert torch.equal(fn(view), fn(aligned))


def test_compress_launches_one_warp_per_row_and_count_once(card):
    cfg = codec_from_spec("taco").cfg
    before = [ash_compress.compress_blocks.launches,
              ash_compress.compress_wire.launches]
    x = torch.zeros((3, 1792), device=card)
    ash_compress.compress_blocks(x.reshape(-1, 256), cfg)
    ash_compress.compress_wire(x, cfg)
    torch.cuda.synchronize()
    assert [ash_compress.compress_blocks.launches - before[0],
            ash_compress.compress_wire.launches - before[1]] == [1, 1]


# --------------------------------------------------------------------------
# K1 and K2's persistent grid (ash_compress.geometry): its edges
# --------------------------------------------------------------------------

def _grid_edge_rows(b, dtype):
    """Row counts at the edges of K1's launch at width ``b``: 1 row, the
    serve hop's 14, a warp's rows and a block's at both lane widths
    (``KEPT_E``, ``LATENCY_E``), the first row count at ``KEPT_E`` and a
    whole grid pass, each +-1, and two passes plus a block and a tail."""
    sms = ash_compress.sms(torch.cuda.current_device())
    edges = set()
    for e in (ash_compress.KEPT_E[b], ash_compress.LATENCY_E[b]):
        geo = ash_compress.geometry(b, dtype, 1 << 30, sms, e=e)
        edges |= {geo.rows_per_warp, geo.rows_per_block}
    kept = ash_compress.geometry(b, dtype, 1 << 30, sms)
    full = kept.grid * kept.rows_per_block
    edges |= {full, sms * kept.rows_per_block - kept.rows_per_warp + 1}
    return sorted({c for k in edges for c in (k - 1, k, k + 1) if c >= 1}
                  | {1, 14, 2 * full + kept.rows_per_block + 3})


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [32, 256, 512])
def test_compress_grid_edges(card, b, in_dtype, rng):
    """At every row count of ``_grid_edge_rows``: K1 on the first rows
    equals K1's one launch over all the rows on those rows, and K2 on them
    as one slot equals the packed rows, bit for bit; the one launch is the
    plain version's bits."""
    cfg = codec_from_spec(f"taco:b{b}").cfg
    counts = _grid_edge_rows(b, in_dtype)
    x = torch.from_numpy(tp_like(rng, (counts[-1], b))).to(card, in_dtype)
    whole = ash_compress.compress_blocks(x, cfg)
    _assert_same_bits(whole, ref.compress_blocks_ref(x, cfg))
    for rows in counts:
        part = tuple(t[:rows] for t in whole)
        _assert_same_bits(ash_compress.compress_blocks(x[:rows], cfg), part)
        assert torch.equal(
            ash_compress.compress_wire(x[:rows].reshape(1, -1), cfg),
            ref.blocks_to_wire(*part, cfg, 1, rows * b)), rows


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_compress_grid_on_unaligned_views(card, in_dtype, offset, rng):
    """A view at element offset 1-3 over two grid passes and a tail (7
    slots of K2): K1 and K2 take the narrower loads and give the plain
    version's bits, and the bytes of the aligned copy."""
    cfg = codec_from_spec("taco:folded:g64").cfg
    sms = ash_compress.sms(torch.cuda.current_device())
    geo = ash_compress.geometry(256, in_dtype, 1 << 30, sms)
    rows = 7 * ((2 * geo.grid * geo.rows_per_block + 7) // 7 + 1)
    base = torch.from_numpy(tp_like(rng, (rows * 256 + offset,))).to(
        card, in_dtype)
    view = base[offset:].view(rows, 256)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = ash_compress.compress_blocks(view, cfg)
    _assert_same_bits(got, ref.compress_blocks_ref(view.clone(), cfg))
    _assert_same_bits(got, ash_compress.compress_blocks(view.clone(), cfg))
    wire = ash_compress.compress_wire(view.reshape(7, -1), cfg)
    assert torch.equal(wire, ash_compress.compress_wire(
        view.reshape(7, -1).clone(), cfg))
    assert torch.equal(wire, ref.compress_wire_ref(view.reshape(7, -1), cfg))


@pytest.mark.parametrize("spec", ["taco:folded", "taco:int8:g128"])
def test_compress_wire_grid_rows_at_4_byte_offsets(card, spec, rng):
    """3001 slots of n = 1792 (7 rows each, total = 4 mod 8): every odd
    slot's rows start 4-byte aligned only, and the rows span more than one
    grid pass; K2 equals pack(K1) and the plain version's wire bit for
    bit."""
    codec = codec_from_spec(spec)
    slots, n = 3001, 1792
    x = torch.from_numpy(tp_like(rng, (slots, n))).to(card, torch.bfloat16)
    k2, k1, plain = _k1_k2(x, codec, slots, n)
    assert k2.shape[1] % 8 == 4
    assert torch.equal(k1, k2)
    assert ref.check_compress_wire(k2, plain, n, codec.cfg)["bitwise"]


def test_compress_refuses_what_the_kernels_do_not_take(card):
    """A wire slot that is not whole blocks, a launch geometry the library
    is not built for (an E of neither table; KEPT_E for f32 input): refused,
    and nothing is counted."""
    cfg = codec_from_spec("taco").cfg
    before = ash_compress.compress_wire.launches
    with pytest.raises(ValueError, match="multiple of the block"):
        ash_compress.compress_wire(torch.zeros((1, 300), device=card), cfg)
    x = torch.zeros((8, 256), device=card)
    assert 16 not in (ash_compress.KEPT_E[256], ash_compress.LATENCY_E[256])
    for e in (16, ash_compress.KEPT_E[256]):
        bad = ash_compress.geometry(256, x.dtype, 8, 1, e=e)
        with pytest.raises(RuntimeError, match="launch failed"):
            ash_compress.launch_blocks(ash_compress._lib(), x, cfg, bad)
    assert ash_compress.compress_wire.launches == before


# --------------------------------------------------------------------------
# every block size the kernels are built for, both compute dtypes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("metadata", ["", ":folded"])
@pytest.mark.parametrize("cd", ["", ":cdbfloat16"])
@pytest.mark.parametrize("b", [32, 64, 128, 256, 512])
def test_kernels_every_block_size_and_compute_dtype(card, b, cd, metadata,
                                                    rng):
    """K1 to K6 at each block size of ``ash_compress.BLOCK_SIZES`` under
    an f32 and a bf16 compute dtype (3 slots, 18432 payload bytes): pack(K1)
    == K2, K3(unpack) == K5 and K4(unpack) == K6 bit for bit, K2 the plain
    version's wire bit for bit at f32 (within the parity rule's bf16
    allowances under ``cdbfloat16``), K5 and K6 within the decode tolerance
    of the compute dtype."""
    codec = codec_from_spec(f"taco:b{b}{cd}{metadata}")
    cfg = codec.cfg
    slots, n = 3, 256 * 24
    x = torch.from_numpy(tp_like(rng, (slots, n))).to(card, torch.bfloat16)
    k2, k1, plain = _k1_k2(x, codec, slots, n)
    assert torch.equal(k1, k2)
    ref.check_compress_wire(k2, plain, n, cfg)
    k5 = ash_decompress.decompress_wire(plain, n, cfg)
    k6 = ash_decompress.decompress_reduce_wire(plain, n, cfg)
    assert k5.dtype == k6.dtype == cfg.torch_compute_dtype
    ref.check_decoded_close(k5, ref.decompress_wire_ref(plain, n, cfg), cfg)
    ref.check_decoded_close(k6, ref.decompress_reduce_wire_ref(plain, n, cfg),
                            cfg)
    enc = unpack_wire(plain, codec.wire_layout(n))
    assert torch.equal(codec.decode(enc, n, torch.float32), k5.float())
    assert torch.equal(codec.decode_sum(enc, n, torch.float32),
                       k6.float().reshape(-1))


# --------------------------------------------------------------------------
# F1: the ablation configurations on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["taco:hadamard", "taco:notransform",
                                  "taco:tensorscale", "taco:b128",
                                  "taco:cdbfloat16"])
def test_ablation_hop_on_card_matches_cpu(card, spec, rng):
    """One compressed hop (encode to the wire, decode) of each ablation
    configuration on the card against the same hop on the CPU, through the
    route of ``ops``: a configuration with no kernel (another transform,
    tensor scales) launches none and counts every call in
    ``ops.plain_routes``; ``b128`` and ``cdbfloat16`` launch the kernels
    and count nothing there.  Held by ``ref.check_hop_parity``: the parity
    rule (with a bf16 compute dtype, one bf16 ulp of metadata and a flip
    in 1e-3 of the payload bytes), and the wire bit for bit where
    ``ref.plain_bits`` holds (``b128``)."""
    codec = codec_from_spec(spec)
    x = torch.from_numpy(tp_like(rng, (2, 256 * 64)))
    counters = (ash_compress.compress_blocks, ash_compress.compress_wire,
                ash_decompress.decompress_blocks,
                ash_decompress.decompress_reduce,
                ash_decompress.decompress_wire,
                ash_decompress.decompress_reduce_wire)
    launches = [c.launches for c in counters]
    before = dict(ops.plain_routes)
    ref.check_hop_parity(codec, x, card)
    launched = sum(c.launches - n for c, n in zip(counters, launches))
    routed = sum(ops.plain_routes[k] - before[k] for k in before)
    if ops.supported(codec.cfg):
        assert launched > 0 and routed == 0
    else:
        assert launched == 0 and routed > 0


# --------------------------------------------------------------------------
# K3 and K5: one warp per row, one shared row body
# --------------------------------------------------------------------------

def _k3_k5(wire, cfg, n):
    """K5 on ``wire`` (slots, n) and K3 on its unpacked block fields, both
    (slots, n); with those fields (q (M, B), s (M, G), alpha (M,) | None)."""
    q, s, alpha = ref._block_fields(wire, n, cfg)
    q, s = q.reshape(-1, cfg.block_size), s.reshape(-1, s.shape[-1])
    alpha = None if alpha is None else alpha.reshape(-1)
    k3 = ash_decompress.decompress_blocks(q, s, alpha, cfg)
    k5 = ash_decompress.decompress_wire(wire, n, cfg)
    return k5, k3.reshape(k5.shape), (q, s, alpha)


def _hold_k3_k5(wire, cfg, n):
    """K3(unpack) == K5 bit for bit, K5 within the decode tolerance of the
    plain version, and, under folded f32 metadata, K3 == K4 on one peer bit
    for bit (K4's sum starts from +0, which torch.equal counts equal to
    -0)."""
    k5, k3, (q, s, alpha) = _k3_k5(wire, cfg, n)
    assert torch.equal(k3, k5)
    ref.check_decoded_close(k5, ref.decompress_wire_ref(wire, n, cfg), cfg)
    if alpha is None and cfg.torch_compute_dtype == torch.float32:
        k4 = ash_decompress.decompress_reduce(q[None], s[None], None, cfg)
        assert torch.equal(k3.reshape(k4.shape), k4)
    return k5


@pytest.mark.parametrize("metadata", ["", ":folded"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("gs", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_decompress_kernels_every_group_size(card, gs, fmt, metadata, rng):
    """Every group size (E/gs scales a lane up to one scale per row), every
    format, both metadata layouts, on the plain version's wire (64 rows)."""
    cfg = codec_from_spec(f"taco:{fmt}:g{gs}{metadata}").cfg
    n = 256 * 64
    x = torch.from_numpy(tp_like(rng, (1, n))).to(card, torch.bfloat16)
    _hold_k3_k5(ref.compress_wire_ref(x, cfg), cfg, n)


@pytest.mark.parametrize("spec", ["taco", "taco:folded", "taco:folded:g32",
                                  "taco:int8:g128"])
def test_decompress_wire_rows_at_4_byte_offsets(card, spec, rng):
    """n = 1792 under folded metadata (and dual int8:g128): total = 4 mod 8,
    so every odd slot's payload is 4-byte aligned only; 3 slots (P = 3 for
    K6), 7 rows per slot (a ragged count for 8-row blocks)."""
    cfg = codec_from_spec(spec).cfg
    slots, n = 3, 1792
    x = torch.from_numpy(tp_like(rng, (slots, n))).to(card, torch.bfloat16)
    wire = ref.compress_wire_ref(x, cfg)
    if spec in ("taco:folded", "taco:int8:g128"):
        assert wire.shape[1] % 8 == 4
    _hold_k3_k5(wire, cfg, n)
    ref.check_decoded_close(
        ash_decompress.decompress_reduce_wire(wire, n, cfg),
        ref.decompress_reduce_wire_ref(wire, n, cfg))


@pytest.mark.parametrize("rows", [1, 7, 9, 14, 4099])
def test_decompress_blocks_ragged_row_counts(card, rows, rng):
    """Row counts that are not a multiple of a block's 8 warps: the warps
    past the last row return, every row before it is written."""
    cfg = codec_from_spec("taco:folded").cfg
    n = rows * 256
    x = torch.from_numpy(tp_like(rng, (1, n))).to(card, torch.bfloat16)
    _hold_k3_k5(ref.compress_wire_ref(x, cfg), cfg, n)


@pytest.mark.parametrize("spec", ["taco:g64", "taco:b512:e5m2:g32",
                                  "taco:b64:cdbfloat16:int8",
                                  "taco:b32:folded:g1"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_decompress_wire_views_at_byte_offsets(card, spec, offset, rng):
    """A wire that is a view at byte offset 1, 2 or 3 of a larger buffer:
    K5 and K6 read its f32 fields bytewise and its codes with narrower
    loads, and each equals itself on the aligned wire bit for bit."""
    cfg = codec_from_spec(spec).cfg
    slots, n = 2, 3584
    x = torch.from_numpy(tp_like(rng, (slots, n))).to(card, torch.bfloat16)
    wire = ash_compress.compress_wire(x, cfg)
    buf = torch.empty(wire.numel() + offset, dtype=torch.uint8, device=card)
    view = buf[offset:].view(wire.shape)
    view.copy_(wire)
    assert view.is_contiguous() and view.data_ptr() % 4 == offset
    for fn in (ash_decompress.decompress_wire,
               ash_decompress.decompress_reduce_wire):
        assert torch.equal(fn(view, n, cfg), fn(wire, n, cfg))
    torch.cuda.synchronize()


def test_decompress_launches_one_warp_per_row_and_count_once(card):
    cfg = codec_from_spec("taco").cfg
    wire = ash_compress.compress_wire(torch.zeros((3, 1792), device=card),
                                      cfg)
    counters = (ash_decompress.decompress_blocks,
                ash_decompress.decompress_wire,
                ash_decompress.decompress_reduce,
                ash_decompress.decompress_reduce_wire)
    before = [c.launches for c in counters]
    _k3_k5(wire, cfg, 1792)
    _k4_k6(wire, cfg, 1792)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]


# --------------------------------------------------------------------------
# K4 and K6: one warp per row, one shared row body
# --------------------------------------------------------------------------

def _k4_k6(wire, cfg, n):
    """K6 on the peer stack ``wire`` (P, total) and K4 on its unpacked block
    fields (q (P, M, B), s (P, M, G), alpha (P, M) | None), both (M, B)."""
    q, s, alpha = ref._block_fields(wire, n, cfg)
    return (ash_decompress.decompress_reduce_wire(wire, n, cfg),
            ash_decompress.decompress_reduce(q, s, alpha, cfg))


@pytest.mark.parametrize("rows", [1, 7, 9, 14, 4099])
def test_decompress_reduce_ragged_row_counts(card, rows, rng):
    """Row counts that are not a multiple of a block's 8 warps, 3 peers,
    dual metadata: the warps past the last row return, every row before it
    is written; K4(unpack) == K6 bit for bit, and K6 within the decode
    tolerance of the plain version."""
    cfg = codec_from_spec("taco").cfg
    n = rows * 256
    x = torch.from_numpy(tp_like(rng, (3, n))).to(card, torch.bfloat16)
    wire = ref.compress_wire_ref(x, cfg)
    k6, k4 = _k4_k6(wire, cfg, n)
    assert k6.shape == (rows, 256) and torch.equal(k4, k6)
    ref.check_decoded_close(k6, ref.decompress_reduce_wire_ref(wire, n, cfg),
                            cfg)


# --------------------------------------------------------------------------
# the numerics API and SDP4bit on the card (each draws from a generator of
# its own, so the tests above draw as before)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["taco", "taco:folded", "taco:int8",
                                  "taco:b64"])
def test_taco_compress_decompress_launch_k1_k3(card, spec):
    """``core.taco.compress`` / ``decompress`` on a CUDA tensor launch K1
    and K3 once each; the compressed bytes equal the plain version's on the
    CPU bit for bit, the decompressed values agree within the decode
    tolerance of ``repro_torch.kernels.ref``."""
    from repro_torch.core import taco
    cfg = codec_from_spec(spec).cfg
    gen = np.random.default_rng(19)
    x = torch.from_numpy(tp_like(gen, (4, 50, 130)))
    counters = (ash_compress.compress_blocks, ash_decompress.decompress_blocks)
    before = [c.launches for c in counters]
    c = taco.compress(x.to(card), cfg)
    out = taco.decompress(c, cfg, shape=x.shape, dtype=torch.float32)
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1]
    cp = taco.compress(x, cfg)
    assert taco.wire_bytes(c) == taco.wire_bytes(cp)
    n = c.payload.numel()
    layout = ref._layout(cfg, n)

    def row(cc):
        fields = (cc.payload, cc.scale) + (() if cc.alpha is None
                                           else (cc.alpha,))
        return pack_wire(tuple(f.reshape(1, -1) for f in fields), layout)
    assert ref.check_compress_wire(row(c), row(cp), n, cfg)["bitwise"]
    same = taco.Compressed(cp.payload.to(card), cp.scale.to(card),
                           None if cp.alpha is None else cp.alpha.to(card))
    ref.check_decoded_close(
        taco.decompress(same, cfg, shape=x.shape, dtype=torch.float32),
        taco.decompress(cp, cfg, shape=x.shape, dtype=torch.float32))
    assert out.shape == x.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("spec", ["sdp4bit", "sdp4bit:b64", "sdp4bit:norot"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
def test_sdp4bit_codec_on_card_matches_cpu(card, spec, in_dtype):
    """The SDP4bit codec on the card (plain PyTorch, f64 rotation, TF32
    off) against the CPU on the same input: the wire to the parity rule of
    ``core/dp_compress.py``; decode and the peer-summed decode of one wire
    within 1e-6 of each block's norm."""
    from repro_torch.core import dp_compress
    codec = codec_from_spec(spec)
    gen = np.random.default_rng(20)
    n = 64 * 1024
    x = torch.from_numpy(tp_like(gen, (3, n))).to(in_dtype)
    wire = codec.encode_wire(x.to(card))
    want = codec.encode_wire(x)
    dp_compress.check_wire_parity(wire, want, n, codec.block, x=x.float(),
                                  rotate=codec.rotate)
    exact = dp_compress.check_wire_parity(want, want, n, codec.block)
    dp_compress.check_decoded(
        codec.decode_wire(want.to(card), n, torch.float32),
        codec.decode_wire(want, n, torch.float32), exact["bound"],
        codec.block)
    dp_compress.check_decoded(
        codec.decode_sum_wire(want.to(card), n, torch.float32),
        codec.decode_sum_wire(want, n, torch.float32),
        exact["bound"].sum(dim=0), codec.block)
    assert codec.decode_wire(wire, n, in_dtype).dtype == in_dtype


@pytest.mark.parametrize("spec", ["tahquant", "tahquant:g32", "int8",
                                  "int8:g64"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
def test_group_int8_codecs_on_card_match_cpu(card, spec, in_dtype):
    """TahQuant (the pipeline boundary) and int8 (the weight gather) on
    the card against the CPU on the same input: codes, scales and decodes
    bit for bit (one f32 division and a half-to-even round on both); the
    peer-summed decode of one wire too (peer order)."""
    codec = codec_from_spec(spec)
    gen = np.random.default_rng(21)
    n = 2048 * 40
    x = torch.from_numpy(tp_like(gen, (3, n), scale=1.0)).to(in_dtype)
    wire = codec.encode_wire(x.to(card))
    want = codec.encode_wire(x)
    assert torch.equal(wire.cpu(), want)
    assert torch.equal(codec.decode_wire(want.to(card), n, in_dtype).cpu(),
                       codec.decode_wire(want, n, in_dtype))
    assert torch.equal(
        codec.decode_sum_wire(want.to(card), n, torch.float32).cpu(),
        codec.decode_sum_wire(want, n, torch.float32))


def _pipe_smoke_model(device):
    import dataclasses

    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(smoke_config(get_config("gpt-2.7b")),
                              n_layers=4)
    return Model(cfg, make_plan(cfg, 1, 1), device=device,
                 fsdp_axes=("data",))


@pytest.mark.parametrize("spec", ["baseline", "taco3d", "weight_ag=int8",
                                  "pp=tahquant,weight_ag=int8"])
def test_pipeline_step_on_card_matches_cpu(card, spec):
    """The pipeline step at pipe = 1 (4 microbatches, smoke gpt-2.7b cut
    to 4 layers) on the card against the CPU, same weights and batch:
    loss 1e-3 and grad norm 5e-2 relative (phase 4's bounds); under a TACO
    plan the card launches the compress kernels (the wire form: a smoke
    hop is inside the wire budget), and no plain route."""
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline_parallel as ppl
    cpu, gpu = _pipe_smoke_model("cpu"), _pipe_smoke_model(card)
    init = cpu.init(0)
    batch = SyntheticLM(DataConfig(cpu.cfg.vocab_size, 64, 8)).batch(0)
    ctx = ParallelCtx(plan=from_spec(spec), fsdp_axes=("data",))
    oc = adamw.OptConfig(lr_max=1e-3, lr_min=1e-4, warmup_steps=2,
                         total_steps=10)
    res = {}
    plain = dict(ops.plain_routes)
    compress = (ash_compress.compress_blocks, ash_compress.compress_wire)
    before = sum(k.launches for k in compress)
    for model in (cpu, gpu):
        params = tree_map(lambda a: a.to(model.device).clone(), init)
        step = ppl.build_pipeline_train_step(
            model, ctx, oc, ppl.PipeConfig(stages=1, microbatches=4))
        _, _, m = step(params, adamw.init_opt_state(params),
                       SyntheticLM.place(batch, model.device))
        res[model.device.type] = (float(m["loss"]), float(m["grad_norm"]))
    (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
    assert np.isfinite(lg) and np.isfinite(gg)
    assert abs(lg - lc) / lc < 1e-3 and abs(gg - gc) / gc < 5e-2
    assert ops.plain_routes == plain
    launched = sum(k.launches for k in compress) - before
    assert (launched > 0) == (not ctx.plan.tp_identity)


# --------------------------------------------------------------------------
# the policy layer on the card (chip_smoke.py phase 9a at a smaller size)
# --------------------------------------------------------------------------

def _zle_input(rng, card, rows=64, d=896, zero_from=16):
    x = torch.from_numpy(tp_like(rng, (2, rows, d))).to(card, torch.bfloat16)
    x[:, zero_from:] = 0                  # padded sequence rows
    return x


def test_zle_bytes_on_card_equal_cpu(card, rng):
    """The ZLE stage is plain PyTorch on the card: its bytes of an inner
    wire equal the CPU's bit for bit, and it inverts on the card."""
    from repro_torch.core import lossless as zle
    from repro_torch.core.registry import codec_from_spec
    codec = codec_from_spec("taco+zle")
    x = _zle_input(rng, card)
    inner = codec.inner.encode_wire(x.reshape(1, -1))
    for group in (1, 16, 64):
        got = zle.zle_encode(inner, group)
        want = zle.zle_encode(inner.cpu(), group)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        assert torch.equal(zle.zle_decode(got[1], got[2], inner.shape[-1],
                                          group), inner)


@pytest.mark.parametrize("transport", ["", ":folded:chunks=4"])
def test_negotiated_hop_on_card_equals_static(card, transport, rng):
    """Bootstrap, a negotiated hop narrower than the bound equal to the
    static hop bit for bit (all-gather and reduce-scatter), a dense spike
    that overflows, one resync replay bit-exact."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.registry import codec_from_spec
    codec = codec_from_spec(f"taco+zle{transport}:slot=auto")
    static = codec_from_spec(f"taco+zle{transport}")
    x, dense = _zle_input(rng, card), _zle_input(rng, card, zero_from=64)
    ctl = cc.SlotController()

    def hops(c, v):
        return [cc.all_gather_c(v, None, 1, c, cc.Identity),
                cc.psum_scatter_c(v, None, 1, c, cc.Identity)]
    hops(ctl.negotiate(codec), x)
    assert ctl.finish_step() is False
    neg = ctl.negotiate(codec)
    n = x.numel()
    assert cc.moved_slot_bytes(neg, n) < cc.wire_slot_bytes(codec, n)
    assert all(torch.equal(a, b)
               for a, b in zip(hops(neg, x), hops(static, x)))
    assert ctl.finish_step() is False
    hops(ctl.negotiate(codec), dense)
    assert ctl.finish_step() is True
    replay = hops(ctl.negotiate(codec), dense)
    assert ctl.finish_step() is False and ctl.resyncs == 1
    assert all(torch.equal(a, b)
               for a, b in zip(replay, hops(static, dense)))


def test_err_probe_on_card_adds_one_decompress_launch(card, rng):
    """Under escalate= a hop decodes one wire row back for its probe: one
    more decompress launch (K5 at this size), and its value is read with
    one copy by drain_probes."""
    from repro_torch.core import collectives as cc
    from repro_torch.core import policy
    from repro_torch.core.registry import codec_from_spec
    esc = policy.ErrorEscalationController()
    x = torch.from_numpy(tp_like(rng, (1, 3584))).to(card)
    counters = (ash_compress.compress_wire, ash_decompress.decompress_wire)
    for spec, extra in (("taco", 0), ("taco:escalate=bf16@0.1", 1)):
        c = codec_from_spec(spec)
        before = [k.launches for k in counters]
        cc.all_gather_c(x, None, 1, c, c)
        assert [k.launches - b for k, b in zip(counters, before)] == \
            [1, 1 + extra]
    cc.drain_probes()
    (_, err), = esc._obs
    assert 0.0 < err < 0.1


# --------------------------------------------------------------------------
# the sp hops (sequence parallelism): K1 then K3 at the full-width shapes a
# rank of sp = 2 sends, and the hops through a 1-rank NCCL group
# --------------------------------------------------------------------------

#: full-width qwen2-0.5b at sp = 2, batch 4 x seq 2048 (chip_smoke.py
#: phase 10): (hop, the rank's tensor, wire rows it encodes)
SP_SHAPES = [("ulysses in", (4, 1024, 14, 192), 2),
             ("ulysses out", (4, 2048, 7, 64), 2),
             ("ring kv", (4, 1024, 14, 128), 1)]


@pytest.mark.parametrize("hop,shape,slots", SP_SHAPES,
                         ids=[s[0].replace(" ", "-") for s in SP_SHAPES])
def test_sp_hop_kernels_match_plain(card, hop, shape, slots, rng):
    """The hop's wire rows (``slots`` rows of the rank's tensor) through K1
    equal the plain version's on the CPU bit for bit, K3's decode of them (in
    the codec's f32 compute dtype) against the plain decode, one launch
    each."""
    codec = codec_from_spec("taco:folded")
    cfg = codec.cfg
    n = int(np.prod(shape)) // slots
    x = torch.from_numpy(tp_like(rng, (slots, n))).to(card, torch.bfloat16)
    before = (ash_compress.compress_blocks.launches,
              ash_decompress.decompress_blocks.launches)
    wire = codec.encode_wire(x)
    dec = codec.decode_wire(wire, n, torch.float32)
    assert (ash_compress.compress_blocks.launches - before[0],
            ash_decompress.decompress_blocks.launches - before[1]) == (1, 1)
    assert ref.check_compress_wire(wire, codec.encode_wire(x.cpu()), n,
                                   cfg)["bitwise"]
    ref.check_decoded_close(dec, codec.decode_wire(wire.cpu(), n,
                                                   torch.float32), cfg)


def test_sp_hops_through_a_one_rank_nccl_group(card, tmp_path, rng,
                                               monkeypatch):
    """``all_to_all_c`` (both dim orders) and ``ppermute_c`` over a 1-rank
    NCCL group under ``taco:folded``, on the block route of full-width
    hops: one K1 and one K3 each way, the output the decode of the card's
    wire; Ulysses and the ring at sp = 1 are the monolithic core."""
    import torch.distributed as dist

    from repro_torch.core import collectives as cc
    from repro_torch.core.parallel import CommPlan, ParallelCtx, init_tp_group
    from repro_torch.models import attention as ta
    monkeypatch.setattr(ops, "WIRE_FUSED_MAX_SLOT_ELEMS", 0)
    group = init_tp_group("cuda", init_method=f"file://{tmp_path}/store",
                          world_size=1, rank=0, timeout_s=60)
    try:
        c = codec_from_spec("taco:folded")
        x = torch.from_numpy(tp_like(rng, (2, 64, 4, 48))).to(
            card, torch.bfloat16)
        for fn, lead in ((lambda v: cc.all_to_all_c(v, group, 2, 1, c, c), 2),
                         (lambda v: cc.all_to_all_c(v, group, 1, 2, c, c), 1),
                         (lambda v: cc.ppermute_c(v, group, ((0, 0),), c, c),
                          0)):
            xx = x.clone().requires_grad_(True)
            before = (ash_compress.compress_blocks.launches,
                      ash_decompress.decompress_blocks.launches)
            y = fn(xx)
            y.backward(x)
            assert (ash_compress.compress_blocks.launches - before[0],
                    ash_decompress.decompress_blocks.launches - before[1]) \
                == (2, 2)
            rows = torch.movedim(x, lead, 0).reshape(1, -1)
            dec = c.decode_wire(c.encode_wire(rows), rows.shape[-1],
                                torch.bfloat16)
            assert torch.equal(torch.movedim(y.detach(), lead, 0)
                               .reshape(1, -1), dec)
        q, k, v = (torch.from_numpy(tp_like(rng, (2, 64, 4, 16))).to(
            card, torch.bfloat16) for _ in range(3))
        core = ta.attention_core(q, k, v, causal=True, window=None)
        for mode in ("ulysses", "ring"):
            ctx = ParallelCtx(plan=CommPlan(sp=c), sp_group=group,
                              sp_mode=mode)
            assert torch.equal(ta.sp_attention(q, k, v, ctx, causal=True,
                                               window=None), core)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# rows holding NaN or inf (ref.plant_nonfinite)
# --------------------------------------------------------------------------

def _nonfinite_rows(card, b, dtype, rng):
    """Row counts of a non-finite case and the rows: 64 (K1 / K2 at
    ``LATENCY_E``; enough finite values for the bf16 decode rule, a norm)
    and, for bf16 input, enough rows that K1 / K2 at an f32 compute dtype
    take ``KEPT_E`` (a ragged last warp); each with ``ref.NONFINITE_KINDS``
    planted at drawn rows."""
    counts = [64]
    if dtype == torch.bfloat16:
        sms = ash_compress.sms(card.index or 0)
        r = 32 * ash_compress.KEPT_E[b] // b
        counts.append(sms * (ash_compress.THREADS // 32) * r + 2)
        assert ash_compress.geometry(b, dtype, counts[-1], sms).e == \
            ash_compress.KEPT_E[b]
    for m in counts:
        x, rows = ref.plant_nonfinite(torch.from_numpy(tp_like(rng, (m, b))),
                                      rng)
        yield x.to(card, dtype), rows


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("metadata", ["dual", "folded"])
@pytest.mark.parametrize("gs", [None, 8])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("b", [256, 64])
def test_kernels_on_nonfinite_rows(card, b, fmt, cd, gs, metadata, in_dtype,
                                   rng):
    """K1, K2 and K7 give their plain version's alpha, s and codes on rows
    holding NaN, +-inf, an element whose square overflows, and zeros
    (ref.NONFINITE_RULE: a NaN byte may be another NaN of the format), and
    every row's bits where they give the plain version's (K1 and K2 at an
    f32 compute dtype, K7 always; the parity rule for K1 and K2's ordinary
    rows at bf16); K3-K6 on the plain version's outputs give NaN where it
    does and the rest within the decode tolerance
    (ref.check_kernels_nonfinite)."""
    from repro_torch.core.taco import TacoConfig
    cfg = TacoConfig(block_size=b, fmt=fmt, compute_dtype=cd,
                     quant_group_size=gs, metadata=metadata)
    for x, rows in _nonfinite_rows(card, b, in_dtype, rng):
        assert ref.check_kernels_nonfinite(x, cfg, rows)["apart"] == 0


def test_butterfly_plain_version_on_card_equals_cpu(card):
    """K7's plain version gives the same bits on the card and on the CPU
    (its root in f64, rounded once: PyTorch's CPU f32 sqrt is not always
    correctly rounded), at the training hop's 28,672 TP-like bf16 rows of
    B = 256."""
    from repro_torch.core.taco import TacoConfig
    cfg = TacoConfig()
    x = torch.from_numpy(tp_like(np.random.default_rng(152),
                                 (28672, 256))).to(torch.bfloat16)
    want = ref.compress_blocks_butterfly_ref(x, cfg)
    got = ref.compress_blocks_butterfly_ref(x.to(card), cfg)
    for name, g, w in zip(("q", "alpha", "s"), got, want):
        assert torch.equal(_bits(g.cpu()), _bits(w)), name
