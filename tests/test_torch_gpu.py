"""Kernel-vs-plain tests on the card (marker ``gpu``; they skip without
one).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The three CUDA wire kernels are held against their plain PyTorch versions
on the same inputs with the parity rule of ``repro_torch.kernels.ref``,
and the card's taco decode against the CPU's (plain versions).
"""
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro_torch.core.registry import codec_from_spec
from repro_torch.kernels import ash_compress, ash_decompress, ref

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
