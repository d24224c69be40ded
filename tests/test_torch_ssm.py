"""The hybrid family of the port (hymba: attention and a selective SSM side
by side, full and sliding-window layers interleaved) held against the JAX
package: the SSM layer (``src/repro_torch/models/ssm.py``), the
transformer's hybrid branch and segments, the decode path with its SSM
state, the engine's replayed tick, the sp refusal and the launchers.

Module tests, in f32 on numpy inputs (``COMPUTE_DTYPE`` f32 in both
packages), at rtol 1e-4 / atol 1e-5:

  * ``_depthwise_conv3``; ``_assoc_scan_chunked`` at several chunks of a
    sequence of 32 (the carried state crosses 3 and 7 chunk boundaries),
    at one chunk, and at the fallback (30 steps, chunk 8: one chunk); the
    decays drawn close to 1 so that the carry matters.
  * ``ssm_apply`` on a sequence (chunk 8 of 32, and the default chunk) and
    its ``s == 1`` decode from a drawn state; token-by-token decode ends
    in the train path's final state (``conv`` and ``h``) with its outputs.

``layer_segments`` equals the JAX package's for every registered arch, at
full size and at smoke size (hymba-1.5b: full [0], swa [1-14], full [15],
swa [16-30], full [31]).

Whole model, smoke hymba-1.5b (2 layers: full [0], swa [1]; d 128, 8 / 2
heads of 16, d_ff 192, SSM d_state 8, window 32, vocab 503), weights
carried across by ``Model.from_jax_params``, in f32:

  * tp = 1 in this process: one step's loss and finalized gradients at
    seq 128 under ``baseline`` and ``tp=taco`` (``tests/test_torch_moe.py``'s
    ``TP_BOUNDS``; measured 1.5e-7 / 4.4e-7 and 3.0e-6 / 1.5e-2), and
    teacher-forced decode logits at 6 steps (its ``DECODE_TOL``; measured
    3.7e-7 and 3.4e-7).
  * tp = 2 (gloo, spawned as ``tests/test_torch_dist.py`` does) against the
    JAX package on four forced host devices in a subprocess: the same step
    and decode at the same bounds.

The launchers train and serve smoke hymba; a forced-overflow decode tick
under ``tp=taco+zle:slot=auto`` replays from the SSM state the failed run
read, and its tokens and logits equal a static engine's; a seq axis is
refused, citing the JAX package's measurement.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config, list_configs, make_plan, smoke_config
from repro.core.parallel import ParallelCtx
from repro.core.registry import from_spec
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch.core.parallel import ParallelCtx as TCtx
from repro_torch.core.registry import from_spec as tfrom_spec
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
HYMBA = "hymba-1.5b"
RTOL, ATOL = 1e-4, 1e-5
#: (loss, grads) of a step (tests/test_torch_moe.py's TP_BOUNDS)
TP_BOUNDS = {"baseline": (1e-4, 1e-3), "tp=taco": (1e-3, 7.5e-2)}
#: decode logits, relative per row (tests/test_torch_moe.py's DECODE_TOL)
DECODE_TOL = {"baseline": 2e-2, "tp=taco": 5e-2}
SEQ, BATCH = 128, 2
DECODE_STEPS, DECODE_BATCH = 6, 2
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)
JAX_TIMEOUT_S = 300


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(leaves):
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in leaves])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture
def f32(monkeypatch):
    """Both packages' SSM layers compute in f32."""
    monkeypatch.setattr(jssm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tssm, "COMPUTE_DTYPE", torch.float32)


# --------------------------------------------------------------------------
# the SSM layer
# --------------------------------------------------------------------------

def test_depthwise_conv3_matches_jax():
    gen = np.random.default_rng(1)
    x = gen.normal(size=(2, 9, 24)).astype(np.float32)
    w = gen.normal(size=(3, 24)).astype(np.float32)
    prev = gen.normal(size=(2, 2, 24)).astype(np.float32)
    _close(tssm._depthwise_conv3(_t(x), _t(w), _t(prev)),
           jssm._depthwise_conv3(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(prev)))


def _scan_inputs(s, seed=2):
    gen = np.random.default_rng(seed)
    a = np.exp(-np.abs(gen.normal(0.0, 0.05, (2, s, 6, 4)))).astype(
        np.float32)                                   # decays near 1
    b = gen.normal(size=(2, s, 6, 4)).astype(np.float32)
    h0 = gen.normal(size=(2, 6, 4)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 4), (32, 32), (30, 8),
                                     (32, 256)])
def test_assoc_scan_chunked_matches_jax(s, chunk):
    """Several chunks carry the state; chunk 8 of 30 falls back to one."""
    a, b, h0 = _scan_inputs(s)
    hs, hf = tssm._assoc_scan_chunked(_t(a), _t(b), _t(h0), chunk)
    jhs, jhf = jssm._assoc_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(h0), chunk)
    _close(hs, jhs)
    _close(hf, jhf)
    # the recurrence itself, step by step in f64
    h, want = h0.astype(np.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(hs.numpy(), np.stack(want, 1), rtol=RTOL,
                               atol=ATOL)


def _ssm_case(seed=3):
    """(cfg, plan, params as numpy) of a hymba-like SSM at d 32, N 8."""
    cfg = dataclasses.replace(smoke_config(get_config(HYMBA)), d_model=32)
    gen = np.random.default_rng(seed)
    d, n = cfg.d_model, cfg.ssm.d_state
    p = {"w_in": gen.normal(0, 0.2, (d, 2 * d)),
         "conv_w": gen.normal(0, 0.5, (3, d)),
         "w_bc": gen.normal(0, 0.3, (d, 2 * n + 1)),
         "a_log": gen.normal(-2.5, 1.0, (d, n)),     # slow decays: the
         "d_skip": gen.normal(1.0, 0.1, (d,)),       # state carries far
         "dt_bias": gen.normal(-1.0, 0.5, (d,)),
         "w_out": gen.normal(0, 0.2, (d, d))}
    return cfg, make_plan(cfg, 1, 1), {k: v.astype(np.float32)
                                        for k, v in p.items()}


def _both_ssm(x, p, cfg, plan, state=None, chunk=256):
    jstate = None if state is None else {k: jnp.asarray(v)
                                         for k, v in state.items()}
    tstate = None if state is None else {k: _t(v) for k, v in state.items()}
    jo, js = jssm.ssm_apply(jnp.asarray(x), {k: jnp.asarray(v)
                                             for k, v in p.items()},
                            cfg, plan, ParallelCtx(fsdp_axes=()),
                            state=jstate, chunk=chunk)
    to, ts = tssm.ssm_apply(_t(x), {k: _t(v) for k, v in p.items()}, cfg,
                            plan, TCtx(), state=tstate, chunk=chunk)
    return (to, ts), (jo, js)


@pytest.mark.parametrize("chunk", [8, 256])
def test_ssm_apply_train_matches_jax(f32, chunk):
    cfg, plan, p = _ssm_case()
    x = np.random.default_rng(4).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    (to, ts), (jo, js) = _both_ssm(x, p, cfg, plan, chunk=chunk)
    _close(to, jo)
    for k in ("conv", "h"):
        _close(ts[k], js[k])


def test_ssm_apply_decode_matches_jax(f32):
    cfg, plan, p = _ssm_case()
    gen = np.random.default_rng(5)
    x = gen.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    state = {"conv": gen.normal(size=(3, 2, cfg.d_model)).astype(np.float32),
             "h": gen.normal(size=(3, cfg.d_model, cfg.ssm.d_state)).astype(
                 np.float32)}
    (to, ts), (jo, js) = _both_ssm(x, p, cfg, plan, state=state)
    _close(to, jo)
    for k in ("conv", "h"):
        _close(ts[k], js[k])


def test_decode_steps_end_in_the_train_paths_state(f32):
    """Token-by-token ``s == 1`` steps from zeros give the sequence path's
    outputs and its final ``conv`` and ``h`` (chunk 8 of 24: the carry)."""
    cfg, plan, p = _ssm_case()
    tp = {k: _t(v) for k, v in p.items()}
    x = _t(np.random.default_rng(6).normal(size=(2, 24, cfg.d_model))
           .astype(np.float32))
    out, st = tssm.ssm_apply(x, tp, cfg, plan, TCtx(), chunk=8)
    state = {"conv": torch.zeros(2, 2, cfg.d_model),
             "h": torch.zeros(2, cfg.d_model, cfg.ssm.d_state)}
    steps = []
    for t in range(24):
        o, state = tssm.ssm_apply(x[:, t:t + 1], tp, cfg, plan, TCtx(),
                                  state=state)
        steps.append(o)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), out.numpy(),
                               rtol=RTOL, atol=ATOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(state[k].numpy(), st[k].numpy(),
                                   rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# segments
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", list_configs())
def test_layer_segments_match_jax(name, smoke):
    cfg = get_config(name)
    tcfg = tconfigs.get_config(name)
    if smoke:
        cfg, tcfg = smoke_config(cfg), tconfigs.smoke_config(tcfg)
    want = [(s.kind, s.start, s.count) for s in jtr.layer_segments(cfg)]
    assert [(s.kind, s.start, s.count)
            for s in ttr.layer_segments(tcfg)] == want
    if name == HYMBA and not smoke:
        assert want == [("full", 0, 1), ("swa", 1, 14), ("full", 15, 1),
                        ("swa", 16, 15), ("full", 31, 1)]


@pytest.mark.parametrize("tp", [1, 2])
def test_hymba_specs_and_param_count(tp):
    """The hybrid block's specs are the JAX package's, shape for shape and
    sharding for sharding.  hymba-1.5b's ``param_count`` (the config's
    estimate) is 1,391,875,200; its specs at tp = 1 hold 1,393,460,864
    (the vocab padded to 32,128, the norms, biases and SSM vectors)."""
    from repro.models.model import Model
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model as TModel
    cfg, tcfg = get_config(HYMBA), tconfigs.get_config(HYMBA)
    jspecs = jax.tree_util.tree_leaves(
        Model(cfg, make_plan(cfg, tp, 1)).specs(),
        is_leaf=lambda s: hasattr(s, "tp_dim"))
    flat: list = []
    tree_map(flat.append, TModel(tcfg, tconfigs.make_plan(tcfg, tp, 1),
                                 device="cpu").specs())
    assert [(s.shape, s.fsdp_dim, s.tp_dim, s.init) for s in flat] == \
        [(s.shape, s.fsdp_dim, s.tp_dim, s.init) for s in jspecs]
    assert tcfg.param_count == cfg.param_count == 1_391_875_200
    if tp == 1:
        assert sum(int(np.prod(s.shape)) for s in flat) == 1_393_460_864


# --------------------------------------------------------------------------
# the whole model at tp = 1, in f32
# --------------------------------------------------------------------------

def _f32_both(monkeypatch):
    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.serve.serve_step as jss
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.serve.serve_step as tss
    for mod in (jl, ja, jtr, jssm, jss):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tl, ta, ttr, tssm, tss):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _cfgs():
    return (smoke_config(get_config(HYMBA)),
            tconfigs.smoke_config(tconfigs.get_config(HYMBA)))


def _jax_step_grads(model, params, batch, spec, mesh_shape=(1, 1, 1),
                    devices=None):
    """The JAX train step's loss and finalized grads on a mesh."""
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.optim import adamw as jadamw
    ctx = ParallelCtx(plan=from_spec(spec.replace("taco", "taco:jnp", 1)))
    mesh = compat.make_mesh(mesh_shape, ("pod", "data", "model"),
                            devices=devices)
    pspecs, bspecs = model.partition_specs(), model.batch_pspecs()

    def fn(p, b):
        def loss_fn(q):
            loss_sum, count, _ = model.loss_parts(q, b, ctx)
            return loss_sum / jnp.maximum(count, 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        return loss, jadamw.finalize_grads(grads, model)
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(pspecs, bspecs),
                          out_specs=(P(), pspecs), check_vma=False))
    place = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), params, pspecs)
    loss, grads = f(place, {k: jax.device_put(v, NamedSharding(
        mesh, bspecs[k])) for k, v in batch.items()})
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree_util.tree_leaves(grads)]


def _jax_decode(model, params, spec, toks, mesh_shape=(1, 1, 1),
                devices=None):
    """Teacher-forced decode logits (global vocab shard order), one array
    per step, and the final cache."""
    from jax.sharding import NamedSharding

    import repro.serve.serve_step as jss
    from repro import compat
    ctx = ParallelCtx(plan=from_spec(spec.replace("taco", "taco:jnp", 1)),
                      tp_mode="allreduce")
    mesh = compat.make_mesh(mesh_shape, ("pod", "data", "model"),
                            devices=devices)
    pspecs, cspecs = model.partition_specs(), jss.cache_pspecs(model)
    dec = jax.jit(shard_map(
        lambda q, c, tok, pos: jss.decode_forward(
            q, tok, c, pos, model, ctx, return_logits=True),
        mesh=mesh, in_specs=(pspecs, cspecs, P(), P()),
        out_specs=(P(), cspecs, P(None, None, "model")), check_vma=False))
    cache = jss.init_cache(model, toks.shape[0], 16)
    placed = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), params, pspecs)
    logits = []
    for t in range(toks.shape[1]):
        _, cache, lg = dec(placed, cache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray(t, jnp.int32))
        logits.append(np.asarray(lg, np.float32))
    return logits, jax.device_get(cache)


def _batch(cfg, seq=SEQ, batch=BATCH):
    from repro.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(cfg.vocab_size, seq, batch), cfg).batch(0)


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.float32 if k == "mask" else np.int64)) for k, v in b.items()}


def _decode_tokens(vocab):
    return np.random.default_rng(2503).integers(
        0, vocab, (DECODE_BATCH, DECODE_STEPS)).astype(np.int32)


def _port_step(tmodel, tree, batch, spec, group=None):
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    step = build_train_step(tmodel, TCtx(plan=tfrom_spec(spec), group=group),
                            adamw.OptConfig(**OPT))
    grads, loss = step.grads(tmodel.from_jax_params(tree), batch)
    return float(loss.detach()), [g.float().numpy().copy()
                                  for g in adamw.leaves(grads)]


def _port_decode(tmodel, tree, spec, toks, group=None):
    from repro_torch.serve import serve_step as tss
    params = tmodel.from_jax_params(tree)
    ctx = TCtx(plan=tfrom_spec(spec), group=group)
    cache = tss.init_cache(tmodel, toks.shape[0], 16)
    logits = []
    for t in range(toks.shape[1]):
        _, lg = tss.decode_forward(params, torch.from_numpy(toks[:, t:t + 1]),
                                   cache, t, tmodel, ctx, return_logits=True)
        logits.append(lg.numpy().copy())
    return logits, cache


def _check_decode(port, ref, spec):
    for t, (a, b) in enumerate(zip(port, ref)):
        assert a.shape == b.shape and np.isfinite(a).all()
        errs = [rel(a[i], b[i]) for i in range(a.shape[0])]
        assert max(errs) < DECODE_TOL[spec], (t, errs)


@pytest.mark.parametrize("spec", sorted(TP_BOUNDS))
def test_tp1_train_step_matches_jax(monkeypatch, spec):
    from repro.models.model import Model
    from repro_torch.models.model import Model as TModel
    _f32_both(monkeypatch)
    cfg, tcfg = _cfgs()
    model = Model(cfg, make_plan(cfg, 1, 1))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = _batch(cfg)
    jloss, jgrads = _jax_step_grads(model, params, batch, spec)
    tmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu")
    loss, grads = _port_step(tmodel, jax.device_get(params), _tbatch(batch),
                             spec)
    loss_tol, grad_tol = TP_BOUNDS[spec]
    assert [g.shape for g in grads] == [g.shape for g in jgrads]
    assert abs(loss - jloss) / jloss < loss_tol
    assert rel(_flat(grads), _flat(jgrads)) < grad_tol


@pytest.mark.parametrize("spec", sorted(DECODE_TOL))
def test_tp1_decode_matches_jax(monkeypatch, spec):
    """Teacher-forced logits, and the SSM state after the 6 tokens."""
    from repro.models.model import Model
    from repro_torch.models.model import Model as TModel
    _f32_both(monkeypatch)
    cfg, tcfg = _cfgs()
    model = Model(cfg, make_plan(cfg, 1, 1, remat=False))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    toks = _decode_tokens(cfg.vocab_size)
    jlogits, jcache = _jax_decode(model, params, spec, toks)
    tmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1, remat=False),
                    device="cpu")
    logits, cache = _port_decode(tmodel, jax.device_get(params), spec, toks)
    _check_decode(logits, jlogits, spec)
    for seg, jseg in zip(cache, jcache):
        assert sorted(seg) == sorted(jseg) == ["conv", "h", "k", "v"]
        if spec == "baseline":
            for k in ("conv", "h"):
                np.testing.assert_allclose(seg[k].numpy(), jseg[k],
                                           rtol=1e-3, atol=1e-4)


def test_step_runs_four_taco_sites_a_layer():
    """A smoke hymba step under ``taco`` with full recompute runs
    ``tp_hops_per_step``'s all-gathers and reduce-scatters: the SSM
    branch joins the attention's partial output before its exit, so a
    hybrid layer keeps the dense layer's four sites."""
    from repro_torch.core import collectives as cc
    from repro_torch.models.model import Model as TModel
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    _, tcfg = _cfgs()
    plan = tconfigs.make_plan(tcfg, 1, 1)
    tmodel = TModel(tcfg, plan, device="cpu")
    counts = {"_ag_impl": 0, "_rs_impl": 0}
    saved = {name: getattr(cc, name) for name in counts}

    def counted(name):
        def impl(x, group, dim, codec):
            counts[name] += not isinstance(codec, cc.IdentityCodec)
            return saved[name](x, group, dim, codec)
        return impl
    ctx = TCtx(plan=tfrom_spec("taco"))
    try:
        for name in counts:
            setattr(cc, name, counted(name))
        build_train_step(tmodel, ctx, adamw.OptConfig(**OPT)).grads(
            tmodel.init(0), _tbatch(_batch(_cfgs()[0], seq=32)))
    finally:
        for name, impl in saved.items():
            setattr(cc, name, impl)
    want = ttr.tp_hops_per_step(tcfg, plan, ctx.plan)
    assert [counts["_ag_impl"], counts["_rs_impl"]] == \
        [want["all_gather"], want["reduce_scatter"]] == [14, 12]


# --------------------------------------------------------------------------
# serving: the engine's replayed tick, the launchers, the sp refusal
# --------------------------------------------------------------------------

def replay_against_static(name, max_batch, lens, seed=7):
    """Two engines on one smoke model and one set of prompts: one under
    ``tp=taco+zle:slot=auto`` with a shared controller seeded from a
    mostly-zero sample of the decode hop (its first negotiated tick is too
    narrow: it overflows and is replayed at the static bound), one under
    the static ``tp=taco+zle``.  Returns (controller, tokens and logits of
    each)."""
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import make_plan as tplan
    from repro_torch.configs import smoke_config as tsmoke
    from repro_torch.core import collectives as cc
    from repro_torch.core import registry as treg
    from repro_torch.models.model import Model as TModel
    from repro_torch.serve.engine import ServeEngine
    cfg = tsmoke(tget(name))
    model = TModel(cfg, tplan(cfg, 1, 1, remat=False), device="cpu")
    params = model.init(0)
    spec = "tp=taco+zle:slot=auto"
    shared = cc.SlotController()
    x = np.zeros((1, max_batch * cfg.d_model), np.float32)
    x[0, :32] = np.random.default_rng(0).normal(0, 0.02, 32)
    shared.observe_sample(treg.from_spec(spec).tp_fwd,
                          torch.from_numpy(x).to(torch.bfloat16))
    assert shared.finish_step() is False
    assert max(shared.negotiate(treg.from_spec(spec).tp_fwd).moved_frac) < 1
    gen = np.random.default_rng(seed)
    prompts = [gen.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    runs = {}
    for kind, s, ctl in (("auto", spec, shared),
                         ("static", "tp=taco+zle", None)):
        eng = ServeEngine(model, TCtx(plan=treg.from_spec(s)), params,
                          max_batch=max_batch, max_len=32,
                          prefill_buckets=(4, 8), device="cpu",
                          collect_logits=True, slot_controller=ctl)
        reqs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run_until_drained()
        runs[kind] = ([r.tokens for r in reqs],
                      [np.stack(r.logit_rows) for r in reqs])
    return shared, runs


def test_replayed_tick_restarts_from_the_ssm_state_it_read():
    shared, runs = replay_against_static(HYMBA, 4, (4, 6, 3))
    assert shared.overflows >= 1 and shared.resyncs >= 1
    assert runs["auto"][0] == runs["static"][0]
    for a, b in zip(runs["auto"][1], runs["static"][1]):
        np.testing.assert_array_equal(a, b)


def test_a_seq_axis_is_refused_citing_the_reference():
    from repro_torch.models.model import Model as TModel
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match=r"6\.3247 / 2\.707"):
        TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu",
               sp_axis="seq", sp=2, sp_rank=0)


def test_serve_launcher_serves_hymba_smoke(capsys):
    from repro_torch.launch import serve
    s = serve.main(["--arch", HYMBA, "--smoke", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "4", "--gen", "5",
                    "--max-batch", "2", "--comm-spec", "taco"])
    assert s["requests"] == 3 and s["total_new_tokens"] == 15
    assert "served 3 requests / 15 tokens" in capsys.readouterr().out


def test_train_launcher_trains_hymba_smoke():
    from repro_torch.launch import train
    args = train.parse_args(["--arch", HYMBA, "--smoke", "--device", "cpu",
                             "--steps", "2", "--seq", "32", "--batch", "2",
                             "--comm-spec", "taco"])
    trainer, cfg = train.build_trainer(args)
    assert cfg.family == "hybrid"
    _, _, hist = trainer.run()
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_pipeline_step_refuses_the_segmented_hybrid():
    """The JAX package's pipeline step runs single-segment archs only (its
    ``assert len(layer_segments(cfg)) == 1``); the port's refuses hymba's
    segments too."""
    from repro_torch.models.model import Model as TModel
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline_parallel as tpl
    _, tcfg = _cfgs()
    assert len(ttr.layer_segments(tcfg)) == 2
    model = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu",
                   fsdp_axes=("data",))
    with pytest.raises(NotImplementedError, match="single-segment"):
        tpl.build_pipeline_train_step(
            model, TCtx(plan=tfrom_spec("baseline"), fsdp_axes=("data",)),
            adamw.OptConfig(**OPT), tpl.PipeConfig(stages=1, microbatches=2))


# --------------------------------------------------------------------------
# tp = 2 across processes, against the JAX package at four host devices
# --------------------------------------------------------------------------

def jax_reference(out: str) -> None:
    """The JAX package on four forced host devices, in f32, at tp = 2 (the
    first two devices): one step's loss and grads and a decode's logits
    under each spec."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.serve.serve_step as jss
    from repro.models.model import Model
    for mod in (jl, ja, jtr, jssm, jss):
        mod.COMPUTE_DTYPE = jnp.float32
    assert len(jax.devices()) == 4
    cfg, _ = _cfgs()
    devs = jax.devices()[:2]
    model = Model(cfg, make_plan(cfg, 2, 1))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = _batch(cfg)
    res = {"tree": jax.device_get(params),
           "batch": {k: np.asarray(v) for k, v in batch.items()}}
    smodel = Model(cfg, make_plan(cfg, 2, 1, remat=False))
    toks = _decode_tokens(cfg.vocab_size)
    for spec in TP_BOUNDS:
        res[("step", spec)] = _jax_step_grads(model, params, batch, spec,
                                              (1, 1, 2), devs)
        res[("decode", spec)] = _jax_decode(smodel, params, spec, toks,
                                            (1, 1, 2), devs)[0]
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def _tp2_task(rank, p, group, pl):
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.serve.serve_step as tss
    from repro_torch.models.model import Model as TModel
    for mod in (tl, ta, ttr, tssm, tss):
        mod.COMPUTE_DTYPE = torch.float32
    _, tcfg = _cfgs()
    model = TModel(tcfg, tconfigs.make_plan(tcfg, 2, 1), device="cpu",
                   tp_rank=rank)
    smodel = TModel(tcfg, tconfigs.make_plan(tcfg, 2, 1, remat=False),
                    device="cpu", tp_rank=rank)
    toks = _decode_tokens(tcfg.vocab_size)
    res = {}
    for spec in TP_BOUNDS:
        res[("step", spec)] = _port_step(model, pl["tree"],
                                         _tbatch(pl["batch"]), spec, group)
        res[("decode", spec)] = _port_decode(smodel, pl["tree"], spec, toks,
                                             group)[0]
    return res


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """The JAX package's results and the port's gloo world, run side by
    side (:func:`test_torch_dist.beside`) on the same inputs: the JAX
    package's seeded init needs no device of its own, so this process
    draws the subprocess's weights bit for bit."""
    from repro.models.model import Model
    from test_torch_dist import beside, run_group
    tmp = tmp_path_factory.mktemp("ssm")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cfg, _ = _cfgs()
    inputs = {"tree": jax.device_get(Model(cfg, make_plan(cfg, 2, 1)).init(
        jax.random.PRNGKey(0), dtype=jnp.float32)),
              "batch": {k: np.asarray(v) for k, v in _batch(cfg).items()}}
    ranks, rc, log = beside(
        [sys.executable, __file__, str(tmp / "jax.pkl")], env,
        tmp / "jax.log", JAX_TIMEOUT_S,
        lambda: run_group(tmp, 2, _tp2_task, inputs))
    assert rc == 0, log
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    for key, value in inputs.items():
        for a, b in zip(jax.tree_util.tree_leaves(ref[key]),
                        jax.tree_util.tree_leaves(value), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=key)
    return ref, ranks


def _tp2_specs():
    from repro_torch.models.model import Model as TModel
    from repro_torch.optim import adamw
    _, tcfg = _cfgs()
    return adamw.leaves(TModel(tcfg, tconfigs.make_plan(tcfg, 2, 1),
                               device="cpu").specs())


@pytest.mark.parametrize("spec", sorted(TP_BOUNDS))
def test_tp2_train_step_matches_jax(tp2, spec):
    """The replicated leaves (norms, ``branch_gate``) are summed over the
    model axis (``adamw.finalize_grads``) on both ranks alike."""
    ref, ranks = tp2
    jloss, jgrads = ref[("step", spec)]
    (l0, g0), (l1, g1) = ranks[0][("step", spec)], ranks[1][("step", spec)]
    assert l0 == l1
    full = [a if s.tp_dim is None else np.concatenate([a, b], s.tp_dim)
            for s, a, b in zip(_tp2_specs(), g0, g1)]
    for s, a, b in zip(_tp2_specs(), g0, g1):
        if s.tp_dim is None:
            np.testing.assert_array_equal(a, b)
    loss_tol, grad_tol = TP_BOUNDS[spec]
    assert [g.shape for g in full] == [g.shape for g in jgrads]
    assert abs(l0 - jloss) / jloss < loss_tol
    assert rel(_flat(full), _flat(jgrads)) < grad_tol


@pytest.mark.parametrize("spec", sorted(DECODE_TOL))
def test_tp2_decode_matches_jax(tp2, spec):
    ref, ranks = tp2
    port = [np.concatenate([ranks[r][("decode", spec)][t] for r in (0, 1)],
                           axis=-1) for t in range(DECODE_STEPS)]
    _check_decode(port, ref[("decode", spec)], spec)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
