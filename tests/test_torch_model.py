"""The port's decode path against the JAX package: JAX weights carried
across with ``Model.from_jax_params``, then teacher-forced
``decode_forward`` logits compared step by step at smoke size.

Tolerance (relative Frobenius error of the f32 logits):
  * baseline, 2e-2.  Both packages run the model in bf16, but XLA fuses
    elementwise chains in f32 and rounds once while PyTorch rounds each
    op's output, so activations differ by about one bf16 ulp (2^-8 =
    3.9e-3); measured 5e-3, bound at five ulps.
  * taco, 5e-2.  Inputs one bf16 ulp apart land on neighbouring e4m3
    codes for about 1/32 of the elements (3 mantissa bits against 8), each
    a 2^-3-relative step of one rotated element, on every one of the
    2L+1 hops; measured 1.7e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config, make_plan, smoke_config
from repro.core.parallel import ParallelCtx
from repro.core.registry import from_spec
from repro.models.model import Model
from repro.serve import serve_step as ss
from repro_torch import configs as tconfigs
from repro_torch.core.parallel import ParallelCtx as TCtx
from repro_torch.core.registry import from_spec as tfrom_spec
from repro_torch.models.model import Model as TModel
from repro_torch.serve import serve_step as tss
from test_torch_dist import one_thread  # noqa: F401  (autouse)

TOL = {"baseline": 2e-2, "taco": 5e-2, "taco_folded": 5e-2,
       "tp=taco,skip_first=1": 5e-2}


def pair(name, **override):
    """(JAX model, params, port model, port params) at smoke size."""
    cfg = dataclasses.replace(smoke_config(get_config(name)), **override)
    model = Model(cfg, make_plan(cfg, 1, 1, remat=False))
    params = model.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(name)), **override)
    tmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1, remat=False),
                    device="cpu")
    return model, params, tmodel, tmodel.from_jax_params(
        jax.device_get(params))


def jax_decoder(model, params, cache, spec):
    ctx = ParallelCtx(plan=from_spec(spec), tp_mode="allreduce")
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    cs = jax.tree.map(lambda _: P(), cache)

    def step(p, c, tok, pos):
        return ss.decode_forward(p, tok, c, pos, model, ctx,
                                 return_logits=True)
    return jax.jit(shard_map(
        step, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), params), cs, P(), P()),
        out_specs=(P(), cs, P()), check_vma=False))


def run_both(name, spec, *, steps=6, batch=3, staggered=False, **override):
    model, params, tmodel, tparams = pair(name, **override)
    cache = ss.init_cache(model, batch, 16)
    f = jax_decoder(model, params, cache, spec)
    tctx = TCtx(plan=tfrom_spec(spec))
    tcache = tss.init_cache(tmodel, batch, 16)
    toks = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (batch, steps)).astype(np.int32)
    errs = []
    for t in range(steps):
        pos = t + np.arange(batch, dtype=np.int32) if staggered else t
        nj, cache, lj = f(params, cache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(pos, jnp.int32))
        tpos = torch.from_numpy(pos).long() if staggered else t
        nt, lt = tss.decode_forward(tparams, torch.from_numpy(
            toks[:, t:t + 1]), tcache, tpos, tmodel, tctx,
            return_logits=True)
        lj = np.asarray(lj)
        assert lt.shape == lj.shape and nt.shape == (batch, 1)
        assert torch.isfinite(lt).all()
        errs.append(np.linalg.norm(lt.numpy() - lj) / np.linalg.norm(lj))
    return max(errs)


@pytest.mark.parametrize("spec", sorted(TOL))
def test_qwen2_decode_logits_match_jax(spec):
    assert run_both("qwen2-0.5b", spec) < TOL[spec]


def test_per_slot_positions_match_jax():
    assert run_both("qwen2-0.5b", "taco", staggered=True) < TOL["taco"]


@pytest.mark.parametrize("name,override", [
    ("h2o-danube-1.8b", {"window": 4}),         # SWA ring buffer wraps
    ("gpt-350m", {}),                           # learned pos, gelu, LN
    ("gpt-350m", {"pos": "sinusoid"}),
])
def test_other_dense_variants_match_jax(name, override):
    assert run_both(name, "baseline", steps=7, **override) < TOL["baseline"]


def test_from_jax_params_keeps_bits_and_checks_shapes():
    model, params, tmodel, tparams = pair("qwen2-0.5b")
    j = jax.device_get(params)
    table = j["embed"]["table"]
    assert tparams["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams["embed"]["table"].view(torch.int16).numpy(),
        np.asarray(table).view(np.int16))
    j["final_norm"]["scale"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tmodel.from_jax_params(j)


def test_seeded_init_is_deterministic():
    cfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-0.5b"))
    m = TModel(cfg, tconfigs.make_plan(cfg, 1, 1), device="cpu")
    a, b, c = m.init(3), m.init(3), m.init(4)
    ta, tb = a["segments"][0]["attn"]["wq"], b["segments"][0]["attn"]["wq"]
    assert torch.equal(ta, tb)
    assert not torch.equal(ta, c["segments"][0]["attn"]["wq"])
