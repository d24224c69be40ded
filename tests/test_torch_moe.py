"""The MoE family of the port held against the JAX package: the layer
(``src/repro_torch/models/moe.py``), the transformer's moe branch, the
train step's balance loss, the pipeline step (which drops it), the decode
path, ``ParallelCtx.ep_all_to_all`` and the launchers.  Smoke size:
grok-1-314b (4 of its 8 experts at smoke size, top-2, geglu) and
llama4-maverick-400b-a17b (4 of 128, top-1, swiglu), 2 layers, d 128,
d_ff 192, vocab 503; inputs from numpy seeds, weights carried across by
``Model.from_jax_params`` or by their bf16 bits.

In this process (the JAX package on its one CPU device):

  * top-k: ``moe.top_k`` on engineered ties (pairs of equal
    probabilities at the top and across the k-th place, rows all equal)
    equals ``jax.lax.top_k`` index for index and value for value.
  * the router's logits: the JAX package writes a bf16 product cast to
    f32, but under ``jax.jit`` XLA keeps the product in f32 (its default
    ``xla_allow_excess_precision`` drops the bf16 round trip), so the
    jitted logits are not bf16 values.  The port's f32 product routes as
    the jitted package does; rounding the logits to bf16 would not.
  * ``moe_apply``, forward (output, aux) and gradients (of ``sum(out * ct)
    + 0.1 aux`` with respect to the input, the router and the three expert
    weights), one group and four groups (``group`` < tokens, the
    reference's ``lax.map`` over ``jax.checkpoint``), at the default
    capacity factor and at 0.5, where tokens are dropped (asserted).
    Routing equal token for token (the experts, the stable order by
    expert and which choices are kept); output relative 1e-2 (measured
    4.3e-3: the expert products' bf16 rounding, one ulp is 3.9e-3), aux
    absolute 1e-5 (measured 1e-7), every gradient relative 2e-2.
  * decode logits (teacher-forced, 6 steps, batch 3) of both archs under
    ``baseline`` and ``taco``, relative per row of a step:
    ``tests/test_torch_model.py``'s bounds (2e-2 baseline, 5e-2 taco).
    Under ``baseline`` every row is held.  Under ``taco`` the two packages
    quantize inputs one bf16 ulp apart and land on neighbouring codes
    (1.7e-2 relative on the dense model); a token that close to a routing
    tie flips its routing, and its row's logits then differ by a whole
    expert's share (measured: one row of 18 at 9.2e-2, its margin 0.34%
    of its logits' spread).  So a row is excused at a step where one of
    its tokens was within :data:`NEAR_TIE` of a tie (:func:`tie_margin`,
    in the port), and every row with an error over the bound must be such
    a row; at least 80% of the rows are held.
  * one train step (``build_train_step``) of grok-1 under ``baseline`` and
    ``taco``: the reported loss is the cross-entropy alone (1e-3 of the
    JAX package's), the gradients those of the cross-entropy plus ``0.01
    * aux`` (``tests/test_torch_train.py``'s bounds), and the balance term
    moves the router's gradient (the port's gradient without it is
    further from the reference's than the bound).
  * the pipeline step at pipe mesh (1, 1, 1) drops the balance loss as
    the JAX package's ``_stage_forward`` does: in f32, its loss, grad norm
    and updated master weights equal the JAX pipeline step's (1e-6,
    1e-5, 1e-5), and its grad norm differs from the JAX plain step's.
  * a smoke MoE step runs the dense model's TACO hops
    (``tp_hops_per_step``), recompute included.
  * the launchers: ``launch.serve`` and ``launch.train`` with ``--arch
    grok-1-314b --smoke`` on the CPU.

Across processes (gloo, spawned as ``tests/test_torch_dist.py`` does), in
f32, against the JAX package on four forced host devices in a subprocess:

  * tp = 2 (mesh 1, 1, 2) under ``baseline`` and ``tp=taco``: one train
    step's loss and gradients (``tests/test_torch_dist_ref.py``'s bounds:
    identity 1e-4 / 1e-3, measured 7.6e-8 / 4.5e-7; taco 1e-3 / 7.5e-2,
    measured 1.6e-4 / 4.7e-2); the router's decisions on both ranks equal
    to each other bit for bit (the router runs replicated; both ranks
    must see the same all-gathered activations: they do) and, on the JAX
    package's own inputs, to its decisions token for token; a decode of 4
    steps (logits within the bounds of the decode test above; measured
    4.2e-7 and 1.6e-2); ``ep_all_to_all`` against the JAX package's at
    tp = 2 (identity bit for bit, ``taco`` within the decode tolerance
    rtol 1e-4 / atol 1e-5, forward and backward).
  * mesh (1, 2, 2), the expert weights fsdp-sharded over data: the
    identity plan within ``tests/test_torch_dp.py``'s bounds (measured 0
    / 3.9e-7 / 1.3e-6), and ``tp=taco,grad_rs=sdp4bit`` with the loss
    within 1e-3 and the gradients and master weights within
    ``tests/test_torch_pipeline.py``'s taco3d bounds (2e-1 / 2e-2: TACO
    and SDP4bit amplify last-bit differences, ``ROADMAP.md`` F2; measured
    1.2e-5 / 5.7e-2 / 9.0e-3).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import pickle
import sys
import zlib

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
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.core.parallel import ParallelCtx as TCtx
from repro_torch.core.registry import from_spec as tfrom_spec
from repro_torch.models import moe as tmoe
from repro_torch.models.model import _to_tensor
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
GROK = ARCHS[0]
#: (output rel, aux abs, gradient rel) of moe_apply against the JAX package
MOE_BOUNDS = (1e-2, 1e-5, 2e-2)
AUX_WEIGHT = 0.1
#: decode logits, relative per row (tests/test_torch_model.py's)
DECODE_TOL = {"baseline": 2e-2, "taco": 5e-2}
#: a token is near a tie when its top-k margin is under this share of its
#: logits' spread
NEAR_TIE = 1e-2
#: (loss rel, flattened gradient rel) of a bf16 train step (as
#: tests/test_torch_train.py)
TRAIN_TOL = {"baseline": (1e-3, 2e-2), "taco": (1e-3, 1.2e-1)}
SEQ, BATCH = 64, 2
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(leaves):
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in leaves])


def _cfgs(name, **moe):
    """(JAX config, port config) at smoke size, the MoE config overridden
    by ``moe``."""
    cfg = smoke_config(get_config(name))
    tcfg = tconfigs.smoke_config(tconfigs.get_config(name))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return cfg, tcfg


def _bf16(gen, shape, scale):
    """A bf16 JAX array from a numpy draw, and the same bits in torch."""
    a = jnp.asarray(gen.normal(size=shape) * scale, jnp.bfloat16)
    return a, _to_tensor(jax.device_get(a), "cpu")


# --------------------------------------------------------------------------
# top-k and the router's logits
# --------------------------------------------------------------------------

def _tie_rows(case, e):
    """(rows, e) f32 probabilities with the ties of ``case``."""
    gen = np.random.default_rng(zlib.crc32(f"{case}{e}".encode()))
    logits = gen.normal(size=(64, e)).astype(np.float32)
    if case == "all equal":
        logits[:] = 0.25
    elif case == "pair at the top":
        top = logits.argmax(-1)
        other = (top + 1 + gen.integers(0, e - 1, 64)) % e
        logits[np.arange(64), other] = logits[np.arange(64), top]
    elif case == "pair across k":
        order = np.argsort(-logits, -1)
        logits[np.arange(64), order[:, 2]] = logits[np.arange(64), order[:, 1]]
    elif case == "bf16 logits":        # bf16 logits over few experts tie
        logits = np.round(logits * 4) / 4
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("e", [4, 8, 128])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", ["all equal", "pair at the top",
                                  "pair across k", "bf16 logits"])
def test_top_k_on_ties_is_jax_lax_top_k(case, k, e):
    probs = _tie_rows(case, e)
    assert (probs[:, :, None] == probs[:, None, :]).sum() > probs.size
    jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tv, ti = tmoe.top_k(torch.from_numpy(probs.copy()), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@jax.jit
def _jax_logits(xg, wr):
    return (xg @ wr).astype(jnp.float32)       # the reference's line


def test_jitted_logits_are_f32_and_the_port_routes_as_they_do():
    gen = np.random.default_rng(2400)
    e, k, flips = 8, 2, 0
    for _ in range(4):
        xg, txg = _bf16(gen, (1024, 256), 1.0)
        wr, twr = _bf16(gen, (256, e), 0.01)
        jl = np.asarray(_jax_logits(xg, wr))
        as_bf16 = np.asarray(jnp.asarray(jl, jnp.bfloat16), np.float32)
        assert not np.array_equal(jl, as_bf16)
        jte = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(jl)),
                                       k)[1])
        _, _, tte, _ = tmoe.route(txg, twr, e, k)
        np.testing.assert_array_equal(tte.numpy(), jte)
        bte = tmoe.top_k(torch.softmax(torch.from_numpy(as_bf16), -1), k)[1]
        flips += int((bte.numpy() != jte).any(-1).sum())
    assert flips > 0          # bf16 logits would route some tokens apart


def test_stable_argsort_keeps_the_order_of_equal_values():
    v = torch.from_numpy(np.random.default_rng(2401).integers(0, 4, 999))
    want = np.argsort(v.numpy(), kind="stable")
    np.testing.assert_array_equal(tmoe.stable_argsort(v).numpy(), want)


# --------------------------------------------------------------------------
# moe_apply against the JAX package
# --------------------------------------------------------------------------

@jax.jit
def _jax_route_probe(xg, wr):
    return jax.nn.softmax(_jax_logits(xg, wr), axis=-1)


def _jax_dispatch(probs, e, k, cap):
    """The reference's top-k and dispatch lines on one group's probs:
    (top_e, order, keep)."""
    top_e = jax.lax.top_k(probs, k)[1]
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg_start = jnp.searchsorted(se, jnp.arange(e))
    pos = jnp.arange(flat_e.shape[0]) - seg_start[se]
    return tuple(np.asarray(a) for a in (top_e, order, pos < cap))


def _moe_case(name, tokens, group, cf):
    cfg, tcfg = _cfgs(name, **({} if cf is None else
                               {"capacity_factor": cf}))
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.moe.top_k
    gen = np.random.default_rng(zlib.crc32(f"{name}{tokens}{group}{cf}"
                                           .encode()))
    x, tx = _bf16(gen, (2, tokens // 2, d), 1.0)
    shapes = {"router": ((d, e), 0.01), "w1": ((e, d, f), 0.02),
              "w3": ((e, d, f), 0.02), "w2": ((e, f, d), 0.02)}
    jp, tp = {}, {}
    for key, (shape, scale) in shapes.items():
        jp[key], tp[key] = _bf16(gen, shape, scale)
    ct = gen.normal(size=(2, tokens // 2, d)).astype(np.float32)
    return cfg, tcfg, (x, jp), (tx, tp), ct


MOE_CASES = [(name, tokens, group, cf) for name in ARCHS
             for tokens, group, cf in ((128, 4096, None), (256, 64, None),
                                       (128, 4096, 0.5), (256, 64, 0.5))]


@pytest.mark.parametrize("name,tokens,group,cf", MOE_CASES)
def test_moe_apply_matches_jax(name, tokens, group, cf):
    cfg, tcfg, (x, jp), (tx, tp), ct = _moe_case(name, tokens, group, cf)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    g = min(group, tokens)
    cap = jmoe._capacity(g, e, k, cfg.moe.capacity_factor)
    assert tmoe._capacity(g, e, k, tcfg.moe.capacity_factor) == cap
    ctx = ParallelCtx(fsdp_axes=())

    def jfn(xx, pp):
        out, aux = jmoe.moe_apply(xx, pp, cfg, None, ctx, group=group)
        return jnp.sum(out.astype(jnp.float32) * ct) + AUX_WEIGHT * aux, \
            (out, aux)
    (_, (jout, jaux)), (jgx, jgp) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(x, jp)

    # routing, group by group: the experts, the stable order, the drops
    dropped = 0
    for xg, txg in zip(np.asarray(x).reshape(-1, g, cfg.d_model),
                       tx.reshape(-1, g, cfg.d_model)):
        probs = _jax_route_probe(jnp.asarray(xg), jp["router"])
        jte, jorder, jkeep = _jax_dispatch(probs, e, k, cap)
        _, _, tte, _ = tmoe.route(txg, tp["router"], e, k)
        _, _, keep, order = tmoe.dispatch(tte, g, e, k, cap)
        np.testing.assert_array_equal(tte.numpy(), jte)
        np.testing.assert_array_equal(order.numpy(), jorder)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        dropped += int((~keep).sum())
    assert dropped > 0 or cf is None, dropped

    tx.requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    tout, taux = tmoe.moe_apply(tx, tp, tcfg, None, TCtx(), group=group)
    (torch.sum(tout.float() * torch.from_numpy(ct)) + AUX_WEIGHT * taux
     ).backward()
    out_tol, aux_tol, grad_tol = MOE_BOUNDS
    assert tout.dtype == torch.bfloat16 and taux.dtype == torch.float32
    assert rel(tout.detach().float(), np.asarray(jout, np.float32)) < out_tol
    assert abs(float(taux.detach()) - float(jaux)) < aux_tol
    assert rel(tx.grad.float(), np.asarray(jgx, np.float32)) < grad_tol
    for key in tp:
        assert rel(tp[key].grad.float(), np.asarray(jgp[key], np.float32)) \
            < grad_tol, key


# --------------------------------------------------------------------------
# the decode path
# --------------------------------------------------------------------------

def tie_margin(scores, k):
    """Per token, how far its top-k choices (and their order) are from a
    tie: the least gap between neighbours among its k + 1 highest scores,
    over the spread of its scores."""
    srt = scores.detach().sort(-1, descending=True).values
    gaps = srt[:, :k] - srt[:, 1:k + 1]
    return (gaps.min(-1).values / (srt[:, 0] - srt[:, -1])).numpy()


@contextlib.contextmanager
def _margins(rows: list):
    """Within the block, each port router call appends, per token, its
    :func:`tie_margin`."""
    inner = tmoe.route

    def route(xg, wr, e, k):
        out = inner(xg, wr, e, k)
        rows.append(tie_margin(xg.float() @ wr.float(), k))
        return out
    tmoe.route = route
    try:
        yield
    finally:
        tmoe.route = inner


def check_decode(errs, margins, spec):
    """``errs[t][b]``: relative error of row b's logits at step t;
    ``margins[t][b]``: row b's least router margin at step t.  Returns
    (held, excused)."""
    tol = DECODE_TOL[spec]
    errs, margins = np.asarray(errs), np.asarray(margins)
    near = margins < NEAR_TIE
    if spec == "baseline":
        assert (errs < tol).all(), errs
        return errs.size, 0
    assert (errs[~near] < tol).all(), (errs, margins)
    assert (~near).mean() >= 0.8, margins
    return int((~near).sum()), int(near.sum())


def _decode_both(name, spec, steps=6, batch=3):
    from test_torch_model import jax_decoder, pair
    from repro.serve import serve_step as ss
    from repro_torch.serve import serve_step as tss
    model, params, tmodel, tparams = pair(name)
    cache = ss.init_cache(model, batch, 16)
    f = jax_decoder(model, params, cache, spec)
    tctx = TCtx(plan=tfrom_spec(spec))
    tcache = tss.init_cache(tmodel, batch, 16)
    toks = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (batch, steps)).astype(np.int32)
    errs, margins = [], []
    for t in range(steps):
        _, cache, lj = f(params, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.asarray(t, jnp.int32))
        rows: list = []
        with _margins(rows):
            nt, lt = tss.decode_forward(
                tparams, torch.from_numpy(toks[:, t:t + 1]), tcache, t,
                tmodel, tctx, return_logits=True)
        lj, lt = np.asarray(lj), lt.numpy()
        assert lt.shape == lj.shape and nt.shape == (batch, 1)
        assert np.isfinite(lt).all()
        errs.append([rel(lt[b], lj[b]) for b in range(batch)])
        margins.append(np.min(rows, axis=0) if rows else [1.0] * batch)
    return errs, margins


@pytest.mark.parametrize("spec", sorted(DECODE_TOL))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_decode_logits_match_jax(name, spec):
    errs, margins = _decode_both(name, spec)
    check_decode(errs, margins, spec)


# --------------------------------------------------------------------------
# the train step and the pipeline step
# --------------------------------------------------------------------------

def _train_setup(name=GROK):
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    from repro_torch.data import pipeline as tpipe
    from repro_torch.models.model import Model as TModel
    cfg, tcfg = _cfgs(name)
    model = Model(cfg, make_plan(cfg, 1, 1))
    params = model.init(jax.random.PRNGKey(0))
    tmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu")
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    tbatch = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, SEQ, BATCH),
                               tcfg).batch(0)
    return model, params, tmodel, batch, tbatch


#: the jitted objective of each (config, plan, spec, aux weight), compiled
#: once for the module: the tests that call it again (other params, the
#: same shapes) reuse the compiled step
_OBJECTIVES: dict = {}


def _jax_objective_grads(model, params, batch, spec, aux_weight=0.01):
    """The JAX train step's loss_fn (cross-entropy plus the balance term)
    on a 1-device mesh: (cross-entropy, aux, finalized grads)."""
    key = (model.cfg, model.plan, spec, aux_weight)
    if key not in _OBJECTIVES:
        from repro.optim import adamw as jadamw
        ctx = ParallelCtx(plan=from_spec(spec))
        mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
        pspecs = model.partition_specs()

        def fn(p, b):
            def loss_fn(q):
                loss_sum, count, aux = model.loss_parts(q, b, ctx)
                ce = loss_sum / jnp.maximum(count, 1.0)
                return ce + aux_weight * aux, (ce, aux)
            (_, (ce, aux)), grads = jax.value_and_grad(loss_fn,
                                                       has_aux=True)(p)
            return ce, aux, jadamw.finalize_grads(grads, model)
        _OBJECTIVES[key] = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(pspecs, model.batch_pspecs()),
            out_specs=(P(), P(), pspecs), check_vma=False))
    ce, aux, grads = _OBJECTIVES[key](params, batch)
    return float(ce), float(aux), [np.asarray(g, np.float32) for g in
                                   jax.tree_util.tree_leaves(grads)]


def _router_index(tmodel):
    """The router's place among the parameter leaves (pytree order)."""
    from repro_torch.models.layers import tree_map
    marks = tree_map(lambda s: False, tmodel.specs())
    marks["segments"][0]["moe"]["router"] = True
    flat: list = []
    tree_map(flat.append, marks)
    return flat.index(True)


@pytest.mark.parametrize("spec", sorted(TRAIN_TOL))
def test_moe_train_step_matches_jax(spec):
    """``build_train_step`` differentiates the cross-entropy plus 0.01 aux
    and reports the cross-entropy; the full step's metrics too."""
    from repro.optim import adamw as jadamw
    from repro.train.train_step import build_train_step as jbuild
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step as tbuild
    model, params, tmodel, batch, tbatch = _train_setup()
    loss_tol, grad_tol = TRAIN_TOL[spec]
    jce, jaux, jgrads = _jax_objective_grads(model, params, batch, spec)
    assert jaux > 0
    tree = jax.device_get(params)
    step = tbuild(tmodel, TCtx(plan=tfrom_spec(spec)),
                  adamw.OptConfig(**OPT))
    grads, loss = step.grads(tmodel.from_jax_params(tree), tbatch)
    tg = [g.float().numpy() for g in adamw.leaves(grads)]
    assert abs(float(loss.detach()) - jce) / jce < loss_tol
    assert rel(_flat(tg), _flat(jgrads)) < grad_tol
    if spec == "baseline":
        # the balance term is in the gradient: without it the router's is
        # further from the reference's than the port's is
        r = _router_index(tmodel)
        _, _, ce_only = _jax_objective_grads(model, params, batch, spec, 0.0)
        assert rel(ce_only[r], jgrads[r]) > 4 * rel(tg[r], jgrads[r])

    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jstep = jbuild(model, mesh, ParallelCtx(plan=from_spec(spec)),
                   jadamw.OptConfig(**OPT), donate=False)
    _, _, jm = jstep(params, jadamw.init_opt_state(params), batch)
    assert abs(float(jm["loss"]) - jce) / jce < 1e-6     # the CE alone
    tparams = tmodel.from_jax_params(tree)
    _, _, tm = step(tparams, adamw.init_opt_state(tparams), tbatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) / float(jm["loss"]) \
        < loss_tol
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        / float(jm["grad_norm"]) < grad_tol


def test_jax_taco_step_spreads_as_far_by_itself():
    """The taco bound of :data:`TRAIN_TOL` is twice what the JAX package
    does to itself: one norm scale of the first layer nudged by 2^-9 moves
    its taco step's gradients by 6.0e-2 (the baseline's by 6.2e-3), the
    expert weights' by 11-12%: a TACO code flipped by a last-bit
    difference moves its block, and a token near a routing tie follows it
    to another expert.  The port against the JAX package: 7.4e-2."""
    model, params, _, batch, _ = _train_setup()
    _, _, g0 = _jax_objective_grads(model, params, batch, "taco")
    scale = params["segments"][0]["norm1"]["scale"]
    nudged = dict(params, segments=[dict(
        params["segments"][0], norm1={"scale": scale.at[0, 3].add(
            2.0 ** -9)})])
    _, _, g1 = _jax_objective_grads(model, nudged, batch, "taco")
    spread = rel(_flat(g1), _flat(g0))
    assert TRAIN_TOL["taco"][1] / 2 * 0.9 < spread < TRAIN_TOL["taco"][1]


def _f32_both(monkeypatch):
    """Both packages compute in f32 for the test."""
    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.models.transformer as tt
    for mod in (jl, ja, jt, jmoe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tl, ta, tt, tmoe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def test_pipeline_step_drops_the_balance_loss(monkeypatch):
    """At pipe mesh (1, 1, 1), in f32: the port's pipeline step equals the
    JAX package's (which drops aux in ``_stage_forward``) and differs
    from the plain step (which adds it)."""
    from jax.sharding import NamedSharding

    from repro.models.model import Model
    from repro.optim import adamw as jadamw
    from repro.train import pipeline_parallel as jpl
    from repro.train.train_step import build_train_step as jbuild
    from repro_torch.models.model import Model as TModel
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline_parallel as tpl
    _f32_both(monkeypatch)
    cfg, tcfg = _cfgs(GROK)
    _, _, _, batch, tbatch = _train_setup()
    oc = jadamw.OptConfig(**OPT)
    model = Model(cfg, make_plan(cfg, 1, 1), fsdp_axes=("data",))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    mesh = jax.make_mesh((1, 1, 1), ("pipe", "data", "model"))
    ctx = ParallelCtx(fsdp_axes=("data",), plan=from_spec("baseline"))
    pc = jpl.PipeConfig(stages=1, microbatches=2)
    placed = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), params, jpl.pipe_partition_specs(model,
                                                                     pc))
    _, jopt, jm = jpl.build_pipeline_train_step(model, mesh, ctx, oc, pc)(
        placed, jadamw.init_opt_state(params), batch)
    pmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    _, _, jplain = jbuild(Model(cfg, make_plan(cfg, 1, 1)), pmesh,
                          ParallelCtx(plan=from_spec("baseline")), oc,
                          donate=False)(params, jadamw.init_opt_state(params),
                                        batch)

    tmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu",
                    fsdp_axes=("data",))
    tparams = tmodel.from_jax_params(jax.device_get(params))
    step = tpl.build_pipeline_train_step(
        tmodel, TCtx(plan=tfrom_spec("baseline"), fsdp_axes=("data",)),
        adamw.OptConfig(**OPT), tpl.PipeConfig(stages=1, microbatches=2))
    _, topt, tm = step(tparams, adamw.init_opt_state(tparams), tbatch)
    jg, tg = float(jm["grad_norm"]), float(tm["grad_norm"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) / float(jm["loss"]) \
        < 1e-6
    assert abs(tg - jg) / jg < 1e-5
    assert rel(_flat(adamw.leaves(topt["master"])),
               _flat(jax.tree_util.tree_leaves(jopt["master"]))) < 1e-5
    assert abs(float(jplain["grad_norm"]) - jg) / jg > 1e-3


def test_moe_step_runs_the_dense_models_hops():
    """A smoke MoE step under ``taco`` with full recompute runs
    ``tp_hops_per_step``'s all-gathers and reduce-scatters: an MoE layer
    has the dense layer's four sites, and the recompute of a layer stops
    before its exit hop."""
    from repro_torch.core import collectives as cc
    from repro_torch.models import transformer
    from repro_torch.models.model import Model as TModel
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    _, tcfg = _cfgs(GROK)
    plan = tconfigs.make_plan(tcfg, 1, 1)
    assert plan.remat
    tmodel = TModel(tcfg, plan, device="cpu")
    _, _, _, _, tbatch = _train_setup()
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
            tmodel.init(0), tbatch)
    finally:
        for name, impl in saved.items():
            setattr(cc, name, impl)
    want = transformer.tp_hops_per_step(tcfg, plan, ctx.plan)
    assert [counts["_ag_impl"], counts["_rs_impl"]] == \
        [want["all_gather"], want["reduce_scatter"]]


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------

def test_serve_launcher_serves_grok_smoke(capsys):
    from repro_torch.launch import serve
    s = serve.main(["--arch", GROK, "--smoke", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "4", "--gen", "5",
                    "--max-batch", "2", "--comm-spec", "taco"])
    assert s["requests"] == 3 and s["total_new_tokens"] == 15
    assert "served 3 requests / 15 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", ARCHS)
def test_train_launcher_trains_the_moe_archs(name):
    from repro_torch.launch import train
    args = train.parse_args(["--arch", name, "--smoke", "--device", "cpu",
                             "--steps", "2", "--seq", "32", "--batch", "2",
                             "--comm-spec", "taco"])
    trainer, cfg = train.build_trainer(args)
    assert cfg.family == "moe"
    _, _, hist = trainer.run()
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


# --------------------------------------------------------------------------
# across processes: tp = 2 and the mesh (1, 2, 2), in f32
# --------------------------------------------------------------------------

TP_SPECS = ("baseline", "tp=taco")
MESH = (1, 2, 2)
MESH_SPECS = ("baseline", "tp=taco,grad_rs=sdp4bit")
#: (loss, grads) at tp = 2 (tests/test_torch_dist_ref.py's)
TP_BOUNDS = {"baseline": (1e-4, 1e-3), "tp=taco": (1e-3, 7.5e-2)}
#: (loss, grads, master weights) at MESH: tests/test_torch_dp.py's identity
#: bounds and tests/test_torch_pipeline.py's taco3d bounds
MESH_BOUNDS = {"baseline": (1e-6, 1e-5, 1e-5),
               "tp=taco,grad_rs=sdp4bit": (1e-3, 2e-1, 2e-2)}
A2A_SHAPE = (4, 16, 64)
A2A_ORDERS = ((0, 0), (0, 1), (1, 0))
DECODE_STEPS, DECODE_BATCH = 4, 2
JAX_TIMEOUT_S = 400


def _jax_spec(spec):
    return spec.replace("taco", "taco:jnp", 1)


def _a2a_inputs():
    gen = np.random.default_rng(2402)
    return [gen.normal(size=A2A_SHAPE).astype(np.float32) for _ in range(4)]


def _decode_tokens(vocab):
    return np.random.default_rng(2403).integers(
        0, vocab, (DECODE_BATCH, DECODE_STEPS)).astype(np.int32)


def jax_reference(out: str) -> None:
    """The JAX package on four forced host devices, in f32: at tp = 2
    (the first two devices) the train step's loss, grads and routing, a
    decode's logits and ``ep_all_to_all``; at MESH one step per spec."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from jax.sharding import NamedSharding

    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    import repro.serve.serve_step as jss
    from repro import compat
    from repro.core.registry import codec_from_spec
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.train.train_step import build_train_step as jbuild
    for mod in (jl, ja, jt, jmoe, jss):
        mod.COMPUTE_DTYPE = jnp.float32
    assert len(jax.devices()) == 4
    cfg, _ = _cfgs(GROK)
    oc = adamw.OptConfig(**OPT)
    leaves = jax.tree_util.tree_leaves
    update = adamw.adamw_update

    def spy(grads, opt_state, oc, model):
        # the grads leave the step in place of the new params
        return (grads,) + tuple(update(grads, opt_state, oc, model)[1:])

    def place(tree, specs, mesh):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), tree, specs)

    def step(model, mesh, spec, params, batch, catch=True):
        bspecs = model.batch_pspecs()
        adamw.adamw_update = spy if catch else update
        try:
            f = jbuild(model, mesh, ParallelCtx(plan=from_spec(
                _jax_spec(spec))), oc, donate=False)
            first, opt, m = f(place(params, model.partition_specs(), mesh),
                              adamw.init_opt_state(params),
                              {k: jax.device_put(v, NamedSharding(
                                  mesh, bspecs[k])) for k, v in batch.items()})
        finally:
            adamw.adamw_update = update
        return (float(m["loss"]), [np.asarray(g, np.float32)
                                   for g in leaves(first)],
                [np.asarray(w, np.float32) for w in leaves(opt["master"])],
                float(m["grad_norm"]))

    res = {}
    mesh2 = compat.make_mesh((1, 1, 2), ("pod", "data", "model"),
                             devices=jax.devices()[:2])
    model = Model(cfg, make_plan(cfg, 2, 1))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    res["tp tree"] = jax.device_get(params)
    res["tp batch"] = {k: np.asarray(v) for k, v in batch.items()}
    for spec in TP_SPECS:
        res[("tp step", spec)] = step(model, mesh2, spec, params, batch)
        # the router's choices, per device and layer, of the forward
        routes: dict = {}
        inner = jmoe.moe_apply

        def capture(x_full, p, cfg_, plan, ctx, **kw):
            xg = x_full.reshape(-1, x_full.shape[-1])
            probs = jax.nn.softmax((xg @ p["router"]).astype(jnp.float32))
            jax.debug.callback(
                lambda te, x, i: routes.setdefault(int(i), []).append(
                    (np.asarray(te), np.asarray(x))),
                jax.lax.top_k(probs, cfg_.moe.top_k)[1], xg,
                jax.lax.axis_index("model"))
            return inner(x_full, p, cfg_, plan, ctx, **kw)
        jmoe.moe_apply = capture
        try:
            ctx = ParallelCtx(plan=from_spec(_jax_spec(spec)))
            bspecs = model.batch_pspecs()
            f = jax.jit(shard_map(
                lambda q, b: model.loss_parts(q, b, ctx)[0], mesh=mesh2,
                in_specs=(model.partition_specs(), bspecs), out_specs=P(),
                check_vma=False))
            jax.block_until_ready(f(place(params, model.partition_specs(),
                                          mesh2), batch))
            jax.effects_barrier()
        finally:
            jmoe.moe_apply = inner
        res[("tp routes", spec)] = routes
        # a decode: teacher-forced logits, vocab-sharded over the model axis
        smodel = Model(cfg, make_plan(cfg, 2, 1, remat=False))
        sctx = ParallelCtx(plan=from_spec(_jax_spec(spec)),
                           tp_mode="allreduce")
        cspecs = jss.cache_pspecs(smodel)
        pspecs = smodel.partition_specs()
        dec = jax.jit(shard_map(
            lambda q, c, tok, pos: jss.decode_forward(
                q, tok, c, pos, smodel, sctx, return_logits=True),
            mesh=mesh2, in_specs=(pspecs, cspecs, P(), P()),
            out_specs=(P(), cspecs, P(None, None, "model")),
            check_vma=False))
        cache = jss.init_cache(smodel, DECODE_BATCH, 16)
        toks = _decode_tokens(cfg.vocab_size)
        placed = place(params, pspecs, mesh2)
        logits = []
        for t in range(DECODE_STEPS):
            _, cache, lg = dec(placed, cache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32))
            logits.append(np.asarray(lg, np.float32))
        res[("tp decode", spec)] = logits
    # ep_all_to_all at tp = 2, forward and backward
    xs = _a2a_inputs()
    for spec in ("none", "taco"):
        codec = codec_from_spec(_jax_spec(spec))
        ctx = ParallelCtx(plan=dataclasses.replace(
            ParallelCtx().plan, tp_fwd=codec, tp_bwd=codec))
        for split, concat in A2A_ORDERS:
            def f(a, c, split=split, concat=concat, ctx=ctx):
                y, vjp = jax.vjp(lambda v: ctx.ep_all_to_all(
                    v[0], split, concat)[None], a)
                (g,) = vjp(c)
                return y, g
            oshape = list(A2A_SHAPE)
            oshape[split] //= 2
            oshape[concat] *= 2
            ct = np.stack([x.reshape(-1)[::-1].reshape(oshape)
                           for x in xs[:2]])
            y, g = jax.jit(shard_map(
                f, mesh=mesh2, in_specs=(P("model"), P("model")),
                out_specs=(P("model"), P("model")), check_vma=False))(
                    jnp.asarray(np.stack(xs[:2])), jnp.asarray(ct))
            res[("a2a", spec, split, concat)] = (np.asarray(y),
                                                  np.asarray(g))
    # the mesh (1, 2, 2): the expert weights fsdp-sharded over data
    mesh4 = compat.make_mesh(MESH, ("pod", "data", "model"))
    model = Model(cfg, make_plan(cfg, MESH[2], MESH[0] * MESH[1]))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, 4), cfg).batch(0)
    res["mesh tree"] = jax.device_get(params)
    res["mesh batch"] = {k: np.asarray(v) for k, v in batch.items()}
    res["mesh devices"] = np.vectorize(lambda d: d.id)(mesh4.devices)
    for spec in MESH_SPECS:
        res[("mesh step", spec)] = step(model, mesh4, spec, params, batch)
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def _f32_port():
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.models.transformer as tt
    import repro_torch.serve.serve_step as tss
    for mod in (tl, ta, tt, tmoe, tss):
        mod.COMPUTE_DTYPE = torch.float32


@contextlib.contextmanager
def _routes(rows: list):
    """Within the block, each port router call appends its choices."""
    inner = tmoe.route

    def route(xg, wr, e, k):
        out = inner(xg, wr, e, k)
        rows.append((out[2].numpy().copy(), out[0].detach().numpy().copy(),
                     tie_margin(xg.float() @ wr.float(), k)))
        return out
    tmoe.route = route
    try:
        yield
    finally:
        tmoe.route = inner


def _tp2_task(rank, p, group, pl):
    from repro_torch.core.parallel import CommPlan
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.serve import serve_step as tss
    from repro_torch.train.train_step import build_train_step
    _f32_port()
    _, tcfg = _cfgs(GROK)
    model = Model(tcfg, tconfigs.make_plan(tcfg, 2, 1), device="cpu",
                  tp_rank=rank)
    batch = {k: torch.from_numpy(v) for k, v in pl["batch"].items()}
    res = {}
    for spec in TP_SPECS:
        ctx = TCtx(plan=tfrom_spec(spec), group=group)
        step = build_train_step(model, ctx, adamw.OptConfig(**OPT))
        grads, loss = step.grads(model.from_jax_params(pl["tree"]), batch)
        rows: list = []
        with torch.no_grad(), _routes(rows):
            model.loss_parts(model.from_jax_params(pl["tree"]), batch, ctx)
        smodel = Model(tcfg, tconfigs.make_plan(tcfg, 2, 1, remat=False),
                       device="cpu", tp_rank=rank)
        sparams = smodel.from_jax_params(pl["tree"])
        cache = tss.init_cache(smodel, DECODE_BATCH, 16)
        toks = torch.from_numpy(_decode_tokens(tcfg.vocab_size))
        logits, margins = [], []
        for t in range(DECODE_STEPS):
            m: list = []
            with _margins(m):
                _, lg = tss.decode_forward(sparams, toks[:, t:t + 1], cache,
                                           t, smodel, ctx, return_logits=True)
            logits.append(lg.numpy().copy())
            margins.append(np.min(m, axis=0))
        res[spec] = {"loss": float(loss.detach()),
                     "grads": [g.numpy().copy() for g in adamw.leaves(grads)],
                     "routes": rows, "logits": logits, "margins": margins}
    xs = _a2a_inputs()
    for spec in ("none", "taco"):
        codec = codec_from_spec(spec)
        ctx = TCtx(plan=dataclasses.replace(CommPlan(), tp_fwd=codec,
                                            tp_bwd=codec), group=group)
        for split, concat in A2A_ORDERS:
            x = torch.from_numpy(xs[rank]).requires_grad_(True)
            y = ctx.ep_all_to_all(x, split, concat)
            y.backward(torch.from_numpy(
                xs[rank].reshape(-1)[::-1].copy().reshape(y.shape)))
            res[("a2a", spec, split, concat)] = (y.detach().numpy(),
                                                  x.grad.numpy())
    return res


def _mesh_task(rank, p, group, pl):
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    _f32_port()
    _, tcfg = _cfgs(GROK)
    mesh = init_mesh(MESH, "cpu")
    model = Model(tcfg, tconfigs.make_plan(tcfg, MESH[2], MESH[0] * MESH[1]),
                  device="cpu", **mesh.model_kwargs())
    batch = model.batch_slice({k: torch.from_numpy(v)
                               for k, v in pl["batch"].items()})
    res = {"coords": mesh.coords, "fsdp_rank": model.fsdp_rank}
    for spec in MESH_SPECS:
        params = model.from_jax_params(pl["tree"])
        res["w1 shape"] = tuple(params["segments"][0]["moe"]["w1"].shape)
        step = build_train_step(model, mesh.parallel_ctx(tfrom_spec(spec)),
                                adamw.OptConfig(**OPT))
        grads, loss = step.grads(params, batch)
        g = [a.numpy().copy() for a in adamw.leaves(grads)]
        _, opt, m = step.apply(params, adamw.init_opt_state(params), grads,
                               loss)
        res[spec] = (float(m["loss"]), g,
                     [w.numpy().copy() for w in adamw.leaves(opt["master"])],
                     float(m["grad_norm"]))
    return res


def _global(specs, per_rank, coords, shape):
    """Global leaves from per-rank shard leaves: TP shards joined along
    ``tp_dim``, fsdp shards (pod-major) along ``fsdp_dim``."""
    by = {tuple(c): r for r, c in enumerate(coords)}
    d = shape[1]
    out = []
    for i, spec in enumerate(specs):
        fs = range(shape[0] * d if spec.fsdp_dim is not None else 1)
        ms = range(shape[2] if spec.tp_dim is not None else 1)
        rows = []
        for f in fs:
            cols = [per_rank[by[(f // d, f % d, m)]][i] for m in ms]
            rows.append(cols[0] if len(cols) == 1
                        else np.concatenate(cols, axis=spec.tp_dim))
        out.append(rows[0] if len(rows) == 1
                   else np.concatenate(rows, axis=spec.fsdp_dim))
    return out


def _inputs() -> dict:
    """The weights and batches of the tp = 2 and mesh cases, drawn as
    :func:`jax_reference` draws them: the JAX package's seeded init needs
    no device of its own, so this process draws the same bits."""
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    cfg, _ = _cfgs(GROK)
    out = {}
    for key, (tp, fsdp), rows in (("tp", (2, 1), BATCH),
                                  ("mesh", (MESH[2], MESH[0] * MESH[1]), 4)):
        model = Model(cfg, make_plan(cfg, tp, fsdp))
        out[f"{key} tree"] = jax.device_get(model.init(
            jax.random.PRNGKey(0), dtype=jnp.float32))
        out[f"{key} batch"] = {k: np.asarray(v) for k, v in SyntheticLM(
            DataConfig(cfg.vocab_size, SEQ, rows), cfg).batch(0).items()}
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX package's results and the port's gloo worlds, run side by
    side (:func:`test_torch_dist.beside`) on the same inputs; the
    subprocess's draws must be this process's bit for bit."""
    from test_torch_dist import beside, run_group
    tmp = tmp_path_factory.mktemp("moe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    inputs = _inputs()

    def nb(b):
        return {k: v.astype(np.float32 if k == "mask" else np.int64)
                for k, v in b.items()}

    def port():
        tp2 = run_group(tmp, 2, _tp2_task, {"tree": inputs["tp tree"],
                                            "batch": nb(inputs["tp batch"])})
        mesh = run_group(tmp, 4, _mesh_task, {
            "tree": inputs["mesh tree"], "batch": nb(inputs["mesh batch"])})
        return tp2, mesh
    (tp2, mesh), rc, log = beside(
        [sys.executable, __file__, str(tmp / "jax.pkl")], env,
        tmp / "jax.log", JAX_TIMEOUT_S, port)
    assert rc == 0, log
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    for key, value in inputs.items():
        for a, b in zip(jax.tree_util.tree_leaves(ref[key]),
                        jax.tree_util.tree_leaves(value), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=key)
    return ref, tp2, mesh


def _specs(tp, fsdp):
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    _, tcfg = _cfgs(GROK)
    return adamw.leaves(Model(tcfg, tconfigs.make_plan(tcfg, tp, fsdp),
                              device="cpu").specs())


@pytest.mark.parametrize("spec", TP_SPECS)
def test_tp2_train_step_matches_jax(both, spec):
    ref, tp2, _ = both
    loss_tol, grad_tol = TP_BOUNDS[spec]
    jloss, jgrads, _, _ = ref[("tp step", spec)]
    assert tp2[0][spec]["loss"] == tp2[1][spec]["loss"]
    full = _global(_specs(2, 1), [r[spec]["grads"] for r in tp2],
                   [(0, 0, 0), (0, 0, 1)], (1, 1, 2))
    assert [g.shape for g in full] == [g.shape for g in jgrads]
    assert abs(tp2[0][spec]["loss"] - jloss) / jloss < loss_tol
    assert rel(_flat(full), _flat(jgrads)) < grad_tol


@pytest.mark.parametrize("spec", TP_SPECS)
def test_tp2_router_is_the_same_on_both_ranks_and_jaxs(both, spec):
    """The router runs replicated: both ranks decide alike bit for bit
    (probabilities included).  On the JAX package's inputs of each layer
    (its all-gathered activations, caught on both devices) the port's
    router decides as the JAX package's, token for token.  On its own
    inputs the port decides as the JAX package under ``baseline``; under
    ``tp=taco`` the two packages' hops decode a few codes apart (a code
    moves its 256-element block, two tokens here, by up to 3.4%), which
    moves a token near a tie and every later token of its sequence whose
    routing flipped in an earlier layer: measured 5 of 256 token-layers,
    4 of them in the second layer."""
    from repro_torch.models.model import Model
    ref, tp2, _ = both
    a, b = tp2[0][spec]["routes"], tp2[1][spec]["routes"]
    jroutes = ref[("tp routes", spec)]
    assert len(a) == len(b) == 2 and sorted(jroutes) == [0, 1]
    for layer, ((ea, pa, _), (eb, pb, _)) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(ea, eb, err_msg=f"layer {layer}")
        np.testing.assert_array_equal(pa, pb, err_msg=f"layer {layer}")
    _, tcfg = _cfgs(GROK)
    e, k = tcfg.moe.n_experts, tcfg.moe.top_k
    router = Model(tcfg, tconfigs.make_plan(tcfg, 2, 1), device="cpu") \
        .from_jax_params(ref["tp tree"])["segments"][0]["moe"]["router"]
    apart = 0
    for dev in (0, 1):
        assert len(jroutes[dev]) == 2
        for layer, ((e_, _, _), (je, jx)) in enumerate(zip(a, jroutes[dev])):
            _, _, te, _ = tmoe.route(torch.from_numpy(jx),
                                     router[layer].float(), e, k)
            np.testing.assert_array_equal(te.numpy(), je)
            apart += int((e_ != je).any(-1).sum())
    if spec == "baseline":
        assert apart == 0
    else:
        assert apart <= 0.04 * 2 * sum(len(r[0]) for r in a), apart


@pytest.mark.parametrize("spec", TP_SPECS)
def test_tp2_decode_matches_jax(both, spec):
    ref, tp2, _ = both
    jlogits = ref[("tp decode", spec)]
    errs = []
    for t in range(DECODE_STEPS):
        port = np.concatenate([tp2[r][spec]["logits"][t] for r in (0, 1)],
                              axis=-1)
        assert port.shape == jlogits[t].shape
        errs.append([rel(port[b], jlogits[t][b])
                     for b in range(DECODE_BATCH)])
    check_decode(errs, [m for m in tp2[0][spec]["margins"]],
                 "baseline" if spec == "baseline" else "taco")


@pytest.mark.parametrize("split,concat", A2A_ORDERS)
@pytest.mark.parametrize("spec", ["none", "taco"])
def test_ep_all_to_all_matches_jax(both, spec, split, concat):
    ref, tp2, _ = both
    jy, jg = ref[("a2a", spec, split, concat)]
    for r in (0, 1):
        y, g = tp2[r][("a2a", spec, split, concat)]
        if spec == "none":
            np.testing.assert_array_equal(y, jy[r])
            np.testing.assert_array_equal(g, jg[r])
        else:
            np.testing.assert_allclose(y, jy[r], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, jg[r], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spec", MESH_SPECS)
def test_mesh_step_with_fsdp_sharded_experts_matches_jax(both, spec):
    ref, _, mesh = both
    loss_tol, grad_tol, master_tol = MESH_BOUNDS[spec]
    _, tcfg = _cfgs(GROK)
    d, f, e = tcfg.d_model, tcfg.d_ff, tcfg.moe.n_experts
    coords = [r["coords"] for r in mesh]
    assert [mesh[r]["coords"] for r in range(4)] == [
        tuple(int(i) for i in np.argwhere(ref["mesh devices"] == r)[0])
        for r in range(4)]
    assert mesh[0]["w1 shape"] == (tcfg.n_layers, e, d // 2, f // 2)
    jloss, jgrads, jmaster, jnorm = ref[("mesh step", spec)]
    specs = _specs(MESH[2], MESH[0] * MESH[1])
    grads = _global(specs, [r[spec][1] for r in mesh], coords, MESH)
    master = _global(specs, [r[spec][2] for r in mesh], coords, MESH)
    for r in mesh:
        assert r[spec][0] == mesh[0][spec][0]
    assert abs(mesh[0][spec][0] - jloss) / jloss < loss_tol
    assert rel(_flat(grads), _flat(jgrads)) < grad_tol
    assert rel(_flat(master), _flat(jmaster)) < master_tol


if __name__ == "__main__":
    jax_reference(sys.argv[1])
