"""Kernel-vs-plain tests on the card (marker ``gpu``; they skip without
one).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The six CUDA kernels are held against their plain PyTorch versions on the
same inputs with the parity rule of ``repro_torch.kernels.ref``; each
block form against its wire form bit for bit (they share one per-row
body); the card's taco decode and taco train step against the CPU's
(plain versions).
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
    """Each case compares at least 1e4 payload bytes, so the parity rule
    allows the occasional one-code flip (chip_smoke.py holds the serve
    shape itself, slots=1)."""
    cfg = codec_from_spec(spec).cfg
    x = torch.from_numpy(tp_like(rng, (peers, n))).to(card, in_dtype)
    wire = ash_compress.compress_wire(x, cfg)
    ref.check_wire_parity(wire, ref.compress_wire_ref(x, cfg), n, cfg)
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
    ref.check_wire_parity(wire, ref.compress_wire_ref(x, cfg), 768, cfg)
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
    """K1, K3, K4 against their plain versions (each case at least 1e4
    payload bytes, so the parity rule allows the odd one-code flip)."""
    cfg = codec_from_spec(spec).cfg
    x = torch.from_numpy(tp_like(rng, (rows, 256))).to(card, in_dtype)
    q, a, s = ash_compress.compress_blocks(x, cfg)
    qp, ap, sp = ref.compress_blocks_ref(x, cfg)
    layout = ref._layout(cfg, rows * 256)

    def row(q_, a_, s_):
        from repro_torch.core import taco
        pay = taco._storage_to_wire(q_, cfg.format_spec).reshape(1, -1)
        if cfg.metadata == "folded":
            return pack_wire((pay, (s_ / a_[:, None]).reshape(1, -1)), layout)
        return pack_wire((pay, s_.reshape(1, -1), a_.reshape(1, -1)), layout)
    ref.check_wire_parity(row(q, a, s), row(qp, ap, sp), rows * 256, cfg)
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
@pytest.mark.parametrize("b", [64, 256, 512])
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
