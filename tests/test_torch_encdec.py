"""The encoder-decoder family of the port (whisper-small: a non-causal
encoder over stub frame embeddings, a decoder whose every layer adds a
cross-attention over the encoder's output) held against the JAX package,
with ``build_eval_step`` and ``remat_policy='dots'``.

Module tests on numpy inputs, in f32 (``COMPUTE_DTYPE`` f32 in both
packages) at rtol 1e-4 / atol 1e-5, and in bf16 within atol 2^-6
(``tests/test_torch_train.py``'s core test): ``attention_apply`` with
``kv_source`` (the encoder's length unlike the decoder's) and the decode
step's ``_cross_decode`` against a seeded cross cache; the encoder
(``encoder_forward``: two layers and a layernorm) in bf16 within the
decode test's relative 2e-2, as its roundings compound (``_compare``).

Whole model, smoke whisper-small (2 + 2 layers, d 128, 8 heads of 16,
d_ff 192, vocab 503, layernorm, gelu, sinusoid positions, qkv bias) in
bf16, weights carried by ``Model.from_jax_params``, batches from both
packages' ``SyntheticLM`` (equal bit for bit):

  * one step's loss within 1e-3 relative and its finalized grads within
    ``tests/test_torch_train.py``'s ``SPECS`` (relative Frobenius over all
    leaves) at tp = 1 and at tp = 2 (a gloo world of 2 against the JAX
    package at 2 forced host devices, run once in a subprocess);
  * teacher-forced decode logits against a seeded nonzero cross cache
    (the JAX package never fills it: ``serve_step.py``) at
    ``tests/test_torch_model.py``'s ``TOL``, at tp = 1 and 2;
  * ``build_eval_step``; ``remat_policy='dots'`` (grads equal to
    ``'full'``'s bit for bit in the port, within the bounds above of the
    JAX package's ``dots``); the hops of a step against
    ``tp_hops_per_step``, with ``skip_first`` / ``skip_last`` resolved
    over the encoder's and the decoder's layers apart; the spec trees at
    tp = 1 and 2; a checkpoint byte-identical to the JAX package's; the
    pipeline step's refusal; both launchers.

``tests/test_torch_frontend.py`` reuses these helpers for internvl2-1b.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

# every module that binds COMPUTE_DTYPE at import is imported here, before
# a test sets it to f32
import repro.serve.serve_step  # noqa: F401
import repro_torch.serve.serve_step  # noqa: F401
from repro import compat
from repro.compat import shard_map
from repro.configs import get_config, make_plan, smoke_config
from repro.core.parallel import ParallelCtx
from repro.core.registry import from_spec
from repro.models.model import Model
from repro_torch import configs as tconfigs
from repro_torch.core.parallel import ParallelCtx as TCtx
from repro_torch.core.registry import from_spec as tfrom_spec
from repro_torch.models.model import Model as TModel
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WHISPER = "whisper-small"
RTOL, ATOL, BF16_ATOL = 1e-4, 1e-5, 2 ** -6
#: grads, relative Frobenius (tests/test_torch_train.py's SPECS)
SPECS = {"baseline": 2e-2, "tp=taco": 5e-2}
LOSS_TOL = 1e-3
#: decode logits, relative Frobenius a step (tests/test_torch_model.py)
TOL = {"baseline": 2e-2, "tp=taco": 5e-2}
SEQ, BATCH = 64, 2
DECODE_STEPS, DECODE_BATCH, MAX_LEN = 6, 2, 16
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)
JAX_TIMEOUT_S = 300


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flat(leaves):
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in leaves])


def jspec(spec):
    """The JAX package's spec of a test spec: its taco through jnp."""
    return spec.replace("taco", "taco:jnp", 1)


# --------------------------------------------------------------------------
# both packages, one arch: configs, models, batches
# --------------------------------------------------------------------------

def cfgs(name):
    return (smoke_config(get_config(name)),
            tconfigs.smoke_config(tconfigs.get_config(name)))


def models(name, tp=1, rank=0, **plan_kw):
    """(JAX model, port model of TP rank ``rank``) at smoke size."""
    cfg, tcfg = cfgs(name)
    return (Model(cfg, make_plan(cfg, tp, 1, **plan_kw)),
            TModel(tcfg, tconfigs.make_plan(tcfg, tp, 1, **plan_kw),
                   device="cpu", tp_rank=rank))


def batches(name, seq=SEQ, batch=BATCH, step=0):
    """(the JAX package's batch, the port's) of ``SyntheticLM``."""
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.data import pipeline as tpipe
    cfg, tcfg = cfgs(name)
    return (SyntheticLM(DataConfig(cfg.vocab_size, seq, batch),
                        cfg).batch(step),
            tpipe.SyntheticLM(tpipe.DataConfig(tcfg.vocab_size, seq, batch),
                              tcfg).batch(step))


def host(batch) -> dict:
    """A JAX batch as numpy arrays (bf16 keeps its bits)."""
    return {k: np.asarray(v) for k, v in batch.items()}


def to_port(batch) -> dict:
    """A numpy batch in the port's dtypes (token ids int64)."""
    from repro_torch.models.model import _to_tensor
    return {k: _to_tensor(v, "cpu").long() if k in ("tokens", "labels")
            else _to_tensor(v, "cpu") for k, v in batch.items()}


def full_grads(specs, per_rank):
    """Global grads from each TP rank's shards (concatenated along each
    leaf's ``tp_dim``; a replicated leaf must be equal on every rank)."""
    out = []
    for i, s in enumerate(specs):
        parts = [g[i] for g in per_rank]
        if s.tp_dim is None:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
            out.append(parts[0])
        else:
            out.append(np.concatenate(parts, s.tp_dim))
    return out


# --------------------------------------------------------------------------
# the JAX package's step, decode and eval
# --------------------------------------------------------------------------

def _mesh(mesh_shape, devices):
    return compat.make_mesh(mesh_shape, ("pod", "data", "model"),
                            devices=devices)


def _place(tree, specs, mesh):
    return jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), tree, specs)


def jax_step(model, params, batch, spec, mesh_shape=(1, 1, 1), devices=None):
    """The JAX train step's loss and finalized grads (global, numpy)."""
    from repro.optim import adamw as jadamw
    ctx = ParallelCtx(plan=from_spec(jspec(spec)))
    mesh = _mesh(mesh_shape, devices)
    pspecs, bspecs = model.partition_specs(), model.batch_pspecs()

    def fn(p, b):
        def loss_fn(q):
            loss_sum, count, _ = model.loss_parts(q, b, ctx)
            return loss_sum / jnp.maximum(count, 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        return loss, jadamw.finalize_grads(grads, model)
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(pspecs, bspecs),
                          out_specs=(P(), pspecs), check_vma=False))
    loss, grads = f(_place(params, pspecs, mesh),
                    _place(dict(batch), bspecs, mesh))
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree_util.tree_leaves(grads)]


def jax_eval(model, params, batch, spec, mesh_shape=(1, 1, 1)):
    from repro.train.train_step import build_eval_step
    mesh = _mesh(mesh_shape, None)
    step = build_eval_step(model, mesh, ParallelCtx(plan=from_spec(
        jspec(spec))))
    return float(step(params, dict(batch)))


def cross_cache(model, batch=DECODE_BATCH, max_len=MAX_LEN, seed=4):
    """The JAX package's global decode cache at zeros, its cross-attention
    leaves (an encoder-decoder's) filled with seeded bf16 normals."""
    import repro.serve.serve_step as jss
    cache = jax.device_get(jss.init_cache(model, batch, max_len))
    gen = np.random.default_rng(seed)
    for seg in cache:
        for k in ("xk", "xv"):
            if k in seg:
                seg[k] = np.asarray(jnp.asarray(gen.normal(
                    0, 1, seg[k].shape), jnp.bfloat16))
    return cache


def decode_tokens(vocab):
    return np.random.default_rng(2503).integers(
        0, vocab, (DECODE_BATCH, DECODE_STEPS)).astype(np.int32)


def jax_decode(model, params, spec, toks, cache, mesh_shape=(1, 1, 1),
               devices=None):
    """Teacher-forced decode logits (global vocab order), a list of
    (B, 1, V) arrays, from ``cache`` (a global numpy cache)."""
    import repro.serve.serve_step as jss
    ctx = ParallelCtx(plan=from_spec(jspec(spec)), tp_mode="allreduce")
    mesh = _mesh(mesh_shape, devices)
    pspecs, cspecs = model.partition_specs(), jss.cache_pspecs(model)
    dec = jax.jit(shard_map(
        lambda q, c, tok, pos: jss.decode_forward(
            q, tok, c, pos, model, ctx, return_logits=True),
        mesh=mesh, in_specs=(pspecs, cspecs, P(), P()),
        out_specs=(P(), cspecs, P(None, None, "model")), check_vma=False))
    placed = _place(params, pspecs, mesh)
    cache = _place(cache, cspecs, mesh)
    logits = []
    for t in range(toks.shape[1]):
        _, cache, lg = dec(placed, cache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray(t, jnp.int32))
        logits.append(np.asarray(lg, np.float32))
    return logits


# --------------------------------------------------------------------------
# the port's
# --------------------------------------------------------------------------

def port_step(tmodel, tree, batch, spec, group=None):
    """One step's loss and finalized grads of this rank (no update)."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    step = build_train_step(tmodel, TCtx(plan=tfrom_spec(spec), group=group),
                            adamw.OptConfig(**OPT))
    grads, loss = step.grads(tmodel.from_jax_params(tree), batch)
    return float(loss.detach()), [g.float().numpy().copy()
                                  for g in adamw.leaves(grads)]


def port_cache(tmodel, cache):
    """This rank's decode cache from a global numpy one: the kv-head dim
    (3) of the attention leaves cut by the TP rank when it is sharded."""
    from repro_torch.models.model import _to_tensor
    from repro_torch.serve import serve_step as tss
    local = tss.init_cache(tmodel, DECODE_BATCH, MAX_LEN)
    for seg, jseg in zip(local, cache):
        for k, leaf in seg.items():
            a = jseg[k]
            if a.shape[3] != leaf.shape[3]:
                w = leaf.shape[3]
                a = a[:, :, :, tmodel.tp_rank * w:(tmodel.tp_rank + 1) * w]
            leaf.copy_(_to_tensor(a, "cpu"))
    return local


def port_decode(tmodel, tree, spec, toks, cache, group=None):
    from repro_torch.serve import serve_step as tss
    params = tmodel.from_jax_params(tree)
    ctx = TCtx(plan=tfrom_spec(spec), group=group)
    local = port_cache(tmodel, cache)
    logits = []
    for t in range(toks.shape[1]):
        _, lg = tss.decode_forward(params, torch.from_numpy(toks[:, t:t + 1]),
                                   local, t, tmodel, ctx, return_logits=True)
        logits.append(lg.numpy().copy())
    return logits


def check_decode(port, ref, spec):
    errs = []
    for a, b in zip(port, ref, strict=True):
        assert a.shape == b.shape and np.isfinite(a).all()
        errs.append(rel(a, b))
    assert max(errs) < TOL[spec], errs


def check_step(port, ref, spec):
    (loss, grads), (jloss, jgrads) = port, ref
    assert [g.shape for g in grads] == [g.shape for g in jgrads]
    assert abs(loss - jloss) / jloss < LOSS_TOL, (loss, jloss)
    assert rel(flat(grads), flat(jgrads)) < SPECS[spec]


# --------------------------------------------------------------------------
# the JAX package once per module at tp = 1, in this process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp1():
    """Both models, the JAX params, the batches, and every JAX result the
    tp = 1 tests compare with."""
    model, tmodel = models(WHISPER)
    smodel, tsmodel = models(WHISPER, remat=False)
    dmodel, tdmodel = models(WHISPER, remat_policy="dots")
    params = model.init(jax.random.PRNGKey(0))
    jb, tb = batches(WHISPER)
    toks = decode_tokens(model.cfg.vocab_size)
    cache = cross_cache(smodel)
    ref = {"tree": jax.device_get(params), "jb": jb, "tb": tb,
           "toks": toks, "cache": cache, "tmodel": tmodel,
           "tsmodel": tsmodel, "tdmodel": tdmodel}
    for spec in SPECS:
        ref[("step", spec)] = jax_step(model, params, jb, spec)
        ref[("decode", spec)] = jax_decode(smodel, params, spec, toks, cache)
    ref[("dots", "tp=taco")] = jax_step(dmodel, params, jb, "tp=taco")
    ref["eval"] = jax_eval(model, params, jb, "tp=taco")
    return ref


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.fixture
def f32(monkeypatch):
    """Both packages' models compute in f32."""
    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    import repro.serve.serve_step as jss
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.models.transformer as tt
    import repro_torch.serve.serve_step as tss
    for mod in (jl, ja, jt, jss):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tl, ta, tt, tss):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _in_mesh(fn, *args):
    """``fn(*args)`` inside a one-device shard_map (the ctx's axis
    names)."""
    mesh = _mesh((1, 1, 1), None)
    specs = tuple(jax.tree.map(lambda _: P(), a) for a in args)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P(),
                             check_vma=False))(*args)


def _module_case(dtype, seed=5):
    """Whisper's smoke params in ``dtype`` (JAX tree), the port's, and
    numpy activations: a decoder input (B, 12, D) and an encoder output
    (B, 20, D) of another length."""
    cfg, tcfg = cfgs(WHISPER)
    model = Model(cfg, make_plan(cfg, 1, 1))
    params = model.init(jax.random.PRNGKey(1), dtype=dtype)
    # nonzero biases and norms, so every term shows
    gen = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (np.asarray(a, np.float32) + gen.normal(
        0, 0.05, a.shape)).astype(np.float32), jax.device_get(params))
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    tmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu")
    x = gen.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    enc = gen.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    return cfg, model, params, tmodel, tmodel.from_jax_params(
        jax.device_get(params)), x, enc


def _compare(got, want, dtype, layers=False):
    """f32: rtol 1e-4 / atol 1e-5.  bf16: one op's output within atol
    2^-6; the output of whole layers (the encoder: two blocks and a
    layernorm, values up to |x| ~ 4) within the decode test's baseline
    ``TOL``, relative Frobenius, as its roundings compound: XLA fuses
    elementwise chains in f32 and rounds once, PyTorch rounds each op
    (measured 3 ulps on 8 of 5,120 elements)."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    elif layers:
        assert rel(got, want) < TOL["baseline"]
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


@pytest.fixture(params=["f32", "bf16"])
def dtype(request):
    if request.param == "f32":
        request.getfixturevalue("f32")
        return jnp.float32
    return jnp.bfloat16


def test_cross_attention_matches_jax(dtype):
    """``attention_apply`` with ``kv_source``: keys and values from the
    encoder's output (20 positions against 12 queries), no rope, no
    mask."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    cfg, model, params, _, tparams, x, enc = _module_case(dtype)
    lp = jax.tree.map(lambda a: a[0], params["segments"][0]["xattn"])
    tlp = {k: v[0] for k, v in tparams["segments"][0]["xattn"].items()}
    want = _in_mesh(lambda p, h, e: ja.attention_apply(
        h, p, cfg, model.plan, ParallelCtx(), causal=False,
        kv_source=e), lp, jnp.asarray(x, dtype), jnp.asarray(enc, dtype))
    got = ta.attention_apply(torch.from_numpy(x).to(tparams["final_norm"][
        "scale"].dtype), tlp, model.cfg, model.plan, TCtx(), causal=False,
        kv_source=torch.from_numpy(enc).to(tlp["wq"].dtype))
    assert got.shape == (2, 12, cfg.d_model)
    _compare(got, want, dtype)


def test_cross_attention_is_refused_under_sp():
    from repro_torch.models import attention as ta
    _, _, _, tmodel, tparams, x, enc = _module_case(jnp.float32)
    tlp = {k: v[0] for k, v in tparams["segments"][0]["xattn"].items()}
    ctx = TCtx(sp_group=2)
    with pytest.raises(NotImplementedError, match="active sp axis"):
        ta.attention_apply(torch.from_numpy(x).bfloat16(), tlp, tmodel.cfg,
                           tmodel.plan, ctx, causal=False,
                           kv_source=torch.from_numpy(enc).bfloat16())


def test_encoder_forward_matches_jax(dtype):
    """Two non-causal layers, sinusoid positions, the final norm and the
    closing all-gather, on frames of 20 positions."""
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt
    cfg, model, params, tmodel, tparams, _, enc = _module_case(dtype)
    sub = {"enc_segments": params["enc_segments"],
           "enc_final_norm": params["enc_final_norm"]}
    want = _in_mesh(lambda p, f: jt.encoder_forward(
        p, f, cfg, model.plan, ParallelCtx(plan=from_spec("baseline"))),
        sub, jnp.asarray(enc, jnp.bfloat16))
    got = tt.encoder_forward(tparams, torch.from_numpy(enc).bfloat16(),
                             tmodel.cfg, tmodel.plan, TCtx())
    assert got.shape == enc.shape
    _compare(got, want, dtype, layers=True)


def test_cross_decode_matches_jax(dtype):
    """The decode step's cross-attention over a seeded cache of 16
    positions (f32 softmax, head mask, ``wo``)."""
    import repro.serve.serve_step as jss
    from repro_torch.serve import serve_step as tss
    cfg, model, params, tmodel, tparams, x, _ = _module_case(dtype)
    gen = np.random.default_rng(6)
    shape = (2, 16, cfg.n_kv_heads, cfg.hd)
    cache = {k: gen.normal(size=shape).astype(np.float32)
             for k in ("xk", "xv")}
    lp = jax.tree.map(lambda a: a[0], params["segments"][0]["xattn"])
    tlp = {k: v[0] for k, v in tparams["segments"][0]["xattn"].items()}
    h = x[:, :1]
    want = _in_mesh(lambda p, hh, c: jss._cross_decode(
        hh, p, c, cfg, model.plan, ParallelCtx()), lp,
        jnp.asarray(h, dtype), {k: jnp.asarray(v, dtype)
                                for k, v in cache.items()})
    tdt = tlp["wq"].dtype
    got = tss._cross_decode(torch.from_numpy(h).to(tdt), tlp,
                            {k: torch.from_numpy(v).to(tdt)
                             for k, v in cache.items()},
                            tmodel.cfg, tmodel.plan, TCtx())
    assert got.shape == (2, 1, cfg.d_model)
    _compare(got, want, dtype)


# --------------------------------------------------------------------------
# specs, batches, checkpoints
# --------------------------------------------------------------------------

def spec_rows(name, tp):
    """(keystr, shape, fsdp_dim, tp_dim, init) of every leaf of both
    packages' param specs, in pytree order."""
    from repro_torch.ckpt.checkpoint import _leaf_paths
    jmodel, tmodel = models(name, tp)
    jflat = jax.tree_util.tree_flatten_with_path(
        jmodel.specs(), is_leaf=lambda s: hasattr(s, "tp_dim"))[0]
    jrows = [(jax.tree_util.keystr(k), s.shape, s.fsdp_dim, s.tp_dim, s.init)
             for k, s in jflat]
    trows = [(k, s.shape, s.fsdp_dim, s.tp_dim, s.init)
             for k, s in _leaf_paths(tmodel.specs())]
    return jrows, trows


@pytest.mark.parametrize("tp", [1, 2])
def test_spec_tree_is_the_references(tp):
    jrows, trows = spec_rows(WHISPER, tp)
    assert trows == jrows
    keys = [r[0] for r in trows]
    assert "['enc_final_norm']['scale']" in keys
    assert "['enc_segments'][0]['attn']['wq']" in keys
    assert "['segments'][0]['xattn']['bk']" in keys
    assert "['segments'][0]['norm_x']['bias']" in keys
    assert not any(k.startswith("['enc_segments'][0]['xattn']")
                   for k in keys)


def test_full_size_batch_shapes_and_param_count():
    cfg, tcfg = get_config(WHISPER), tconfigs.get_config(WHISPER)
    jm = Model(cfg, make_plan(cfg, 1, 1))
    tm = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu")
    want = {k: s.shape for k, s in jm.batch_shape(2048, 4).items()}
    got = tm.batch_shape(2048, 4)
    assert {k: v[0] for k, v in got.items()} == want
    assert want["frames"] == (4, 1024, 768) and want["tokens"] == (4, 1024)
    assert got["frames"][1] == torch.bfloat16
    from repro_torch.models.layers import tree_map
    sizes: list = []
    tree_map(lambda s: sizes.append(int(np.prod(s.shape))), tm.specs())
    # 12 + 12 layers at d 768, untied head: the config's estimate leaves
    # out the cross-attention, the biases and the norms; the specs hold
    # them, and the vocab padded to 51,968
    assert tcfg.param_count == cfg.param_count == 249_533_952
    assert sum(sizes) == 278_274_048


@pytest.mark.parametrize("step", [0, 3])
def test_frame_batches_are_the_references_bit_for_bit(step):
    jb, tb = batches(WHISPER, seq=32, batch=3, step=step)
    assert sorted(tb) == sorted(jb) == ["frames", "labels", "mask", "tokens"]
    assert tb["frames"].dtype == torch.bfloat16
    assert tb["frames"].shape == (3, 16, 128) and tb["tokens"].shape == (3, 16)
    for k in jb:
        want = np.asarray(jb[k])
        got = tb[k]
        if k == "frames":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_checkpoint_is_the_jax_packages_byte_for_byte(tmp_path, tp1):
    """The JAX package saves a whisper state (params and fresh AdamW
    state); the port's trainer restores it and saves it again: the same
    manifest keys and the same bytes, every leaf."""
    from repro.ckpt import checkpoint as jck
    from repro.optim import adamw as jadamw
    from repro_torch.data import pipeline as tpipe
    from repro_torch.optim import adamw as tadamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tree = tp1["tree"]
    spec = "tp=taco"
    jck.save(str(tmp_path / "jax"), 3,
             {"params": tree, "opt": jax.device_get(
                 jadamw.init_opt_state(tree))}, comm_spec=spec)
    tmodel = tp1["tmodel"]
    tr = Trainer(tmodel, TCtx(plan=tfrom_spec(spec)),
                 tadamw.OptConfig(**OPT),
                 TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path / "jax")),
                 tpipe.SyntheticLM(tpipe.DataConfig(503, 32, 2), tmodel.cfg))
    params, opt, step = tr.try_restore(*tr.init_state()[:2])
    assert step == 3
    tr.tc.ckpt_dir = str(tmp_path / "port")
    tr.save(step, params, opt)
    jdir, pdir = tmp_path / "jax" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    jm = json.loads((jdir / "manifest.json").read_text())
    pm = json.loads((pdir / "manifest.json").read_text())
    assert pm["leaves"] == jm["leaves"]
    keys = [leaf["key"] for leaf in jm["leaves"]]
    assert "['params']['enc_segments'][0]['mlp']['w1']" in keys
    assert "['opt']['mu']['segments'][0]['xattn']['wo']" in keys
    for leaf in jm["leaves"]:
        assert (pdir / leaf["file"]).read_bytes() == \
            (jdir / leaf["file"]).read_bytes(), leaf["key"]


# --------------------------------------------------------------------------
# the whole model at tp = 1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", sorted(SPECS))
def test_tp1_train_step_matches_jax(tp1, spec):
    port = port_step(tp1["tmodel"], tp1["tree"], tp1["tb"], spec)
    check_step(port, tp1[("step", spec)], spec)


@pytest.mark.parametrize("spec", sorted(TOL))
def test_tp1_decode_matches_jax(tp1, spec):
    """Teacher-forced logits against the seeded cross cache: the
    cross-attention adds a nonzero term at every layer."""
    port = port_decode(tp1["tsmodel"], tp1["tree"], spec, tp1["toks"],
                       tp1["cache"])
    check_decode(port, tp1[("decode", spec)], spec)


def test_zero_cross_cache_adds_nothing(tp1):
    """The engine's cache: zeros in ``xk`` / ``xv`` give a uniform softmax
    over zero values, so the cross-attention adds exactly 0 and the
    logits are those of a model whose ``xattn.wo`` is 0 (the JAX
    package's served whisper, ``src/repro/serve/serve_step.py``)."""
    from repro_torch.serve import serve_step as tss
    tmodel = tp1["tsmodel"]
    ctx = TCtx(plan=tfrom_spec("baseline"))
    tok = torch.from_numpy(tp1["toks"][:, :1])
    params = tmodel.from_jax_params(tp1["tree"])
    _, a = tss.decode_forward(params, tok, tss.init_cache(
        tmodel, DECODE_BATCH, MAX_LEN), 0, tmodel, ctx, return_logits=True)
    for seg in params["segments"]:
        seg["xattn"]["wo"].zero_()
    _, b = tss.decode_forward(params, tok, tss.init_cache(
        tmodel, DECODE_BATCH, MAX_LEN), 0, tmodel, ctx, return_logits=True)
    assert torch.equal(a, b)


def test_eval_step_matches_jax(tp1):
    from repro_torch.train.train_step import build_eval_step
    tmodel = tp1["tmodel"]
    params = tmodel.from_jax_params(tp1["tree"])
    step = build_eval_step(tmodel, TCtx(plan=tfrom_spec("tp=taco")))
    loss = step(params, tp1["tb"])
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert not loss.requires_grad
    assert abs(float(loss) - tp1["eval"]) / tp1["eval"] < LOSS_TOL
    # the train step's reported loss is the same forward's
    assert abs(float(loss) - tp1[("step", "tp=taco")][0]) \
        / tp1["eval"] < LOSS_TOL


def test_dots_grads_are_full_recompute_bit_for_bit(tp1):
    """``remat_policy='dots'`` keeps the non-batched matmuls' outputs and
    recomputes the rest: the same values, so the same grads as ``'full'``
    bit for bit, and within the step bounds of the JAX package's own
    ``dots``."""
    spec = "tp=taco"
    full = port_step(tp1["tmodel"], tp1["tree"], tp1["tb"], spec)
    dots = port_step(tp1["tdmodel"], tp1["tree"], tp1["tb"], spec)
    assert tp1["tdmodel"].plan.remat_policy == "dots"
    assert full[0] == dots[0]
    for a, b in zip(full[1], dots[1], strict=True):
        np.testing.assert_array_equal(a, b)
    check_step(dots, tp1[("dots", spec)], spec)


def test_dots_saves_the_matmuls_that_full_recomputes():
    """What ``'dots'`` recomputes: a step under it runs as many
    non-batched matmuls (``aten.mm``) as a step with no recompute, fewer
    than ``'full'``, and as many batched ones (``aten.bmm``: the
    attention's, recomputed) as ``'full'``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls[func] = self.calls.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    batch = batches(WHISPER, seq=32)[1]
    mm, bmm = {}, {}
    for policy in ("full", "dots", "none"):
        _, tmodel = models(WHISPER, remat=policy != "none",
                           remat_policy=policy)
        step = build_train_step(tmodel, TCtx(plan=tfrom_spec("tp=taco")),
                                adamw.OptConfig(**OPT))
        params = tmodel.init(0)
        with Count() as count:
            step.grads(params, batch)
        mm[policy] = count.calls.get(torch.ops.aten.mm.default, 0)
        bmm[policy] = count.calls.get(torch.ops.aten.bmm.default, 0)
    assert mm["dots"] == mm["none"] < mm["full"], mm
    assert bmm["none"] < bmm["dots"] == bmm["full"], bmm


# --------------------------------------------------------------------------
# the hops of a step
# --------------------------------------------------------------------------

def count_step_ops(tmodel, batch, spec, monkeypatch):
    """Calls of each block operator during one step (``grads``), every
    hop on the block route (the route of every full-width hop)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    monkeypatch.setattr(ops, "WIRE_FUSED_MAX_SLOT_ELEMS", 0)
    calls = {}
    for name in ("compress_blocks", "decompress_blocks", "decompress_reduce",
                 "compress_wire", "decompress_wire", "decompress_reduce_wire"):
        def spy(*a, _inner=getattr(ops, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _inner(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    build_train_step(tmodel, TCtx(plan=tfrom_spec(spec)),
                     adamw.OptConfig(**OPT)).grads(tmodel.init(0), batch)
    return calls


def want_ops(hops):
    return {"compress_blocks": hops["all_gather"] + hops["reduce_scatter"],
            "decompress_blocks": hops["all_gather"],
            "decompress_reduce": hops["reduce_scatter"]}


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
@pytest.mark.parametrize("spec", ["taco", "tp=taco,skip_first=1",
                                  "tp_fwd=taco,skip_last=1"])
def test_hops_per_step_are_the_derived_count(policy, spec, monkeypatch):
    """One whisper step's operator calls equal ``tp_hops_per_step``; a
    skipped layer is skipped at both ends of the encoder's run and of the
    decoder's."""
    from repro_torch.models import transformer as tt
    _, tmodel = models(WHISPER, remat=policy != "none",
                       remat_policy=policy)
    calls = count_step_ops(tmodel, batches(WHISPER, seq=32)[1], spec,
                           monkeypatch)
    hops = tt.tp_hops_per_step(tmodel.cfg, tmodel.plan, tfrom_spec(spec))
    assert calls == want_ops(hops)
    le, ld = tmodel.cfg.enc_layers, tmodel.cfg.n_layers
    if spec == "taco":
        fwd_ag, fwd_rs = 2 * le + 3 * ld + 2, 2 * le + 3 * ld + 1
        re_ag, re_rs = (2 * le + 3 * ld, le + 2 * ld) \
            if policy != "none" else (0, 0)
        assert (hops["all_gather"], hops["reduce_scatter"]) == \
            (fwd_ag + re_ag + fwd_rs, fwd_rs + re_rs + fwd_ag)
    if spec.startswith("tp=taco,skip_first"):
        # one layer of each run left compressed: 2 + 3 sites forward
        assert hops["all_gather"] == (2 + 3 + 2) + (2 + 3) * (
            policy != "none") + (2 + 3 + 1)


def test_full_size_hops_are_the_stated_counts():
    """Launches of a full-width step under ``taco`` with per-layer
    recompute: whisper-small (12 + 12 layers) 342 K1 / 183 K3 / 159 K4;
    internvl2-1b's are qwen2-0.5b's (the patches add no hop)."""
    from repro_torch.models import transformer as tt
    for name, (ag, rs) in ((WHISPER, (183, 159)), ("internvl2-1b",
                                                   (146, 122))):
        cfg = tconfigs.get_config(name)
        hops = tt.tp_hops_per_step(cfg, tconfigs.make_plan(cfg, 1, 1),
                                   tfrom_spec("taco"))
        assert (hops["all_gather"], hops["reduce_scatter"]) == (ag, rs)
    cut = dataclasses.replace(tconfigs.get_config("internvl2-1b"),
                              n_layers=12)
    hops = tt.tp_hops_per_step(cut, tconfigs.make_plan(cut, 1, 1),
                               tfrom_spec("taco"))
    assert (hops["all_gather"], hops["reduce_scatter"]) == (74, 62)


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

def test_pipeline_step_refuses_the_encoder_decoder():
    """The JAX package's pipeline step reads tokens, labels and mask only
    and runs its layers with no encoder; the port's refuses and cites it."""
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline_parallel as tpl
    _, tcfg = cfgs(WHISPER)
    model = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu",
                   fsdp_axes=("data",))
    with pytest.raises(NotImplementedError,
                       match=r"pipeline_parallel\.py:115-116.*:72"):
        tpl.build_pipeline_train_step(
            model, TCtx(plan=tfrom_spec("baseline"), fsdp_axes=("data",)),
            adamw.OptConfig(**OPT), tpl.PipeConfig(stages=1, microbatches=2))


def test_greedy_decode_never_emits_a_padded_vocab_id(tp1):
    """The head is padded to a multiple of 128 (smoke vocab 503 to 512);
    with padded rows that win every argmax, the JAX package's decode emits
    ids past the vocabulary, the port's the best id of the vocabulary, its
    logits the reference's (padded columns included)."""
    import repro.serve.serve_step as jss
    from repro_torch.serve import serve_step as tss
    tree = jax.tree.map(np.copy, tp1["tree"])
    table = tree["head"]["table"]
    vocab = tp1["tsmodel"].cfg.vocab_size
    big = np.asarray(table[0], np.float32) * 1000.0
    table[vocab::2] = big.astype(table.dtype)
    table[vocab + 1::2] = (-big).astype(table.dtype)
    smodel, _ = models(WHISPER, remat=False)
    ctx = ParallelCtx(plan=from_spec("baseline"), tp_mode="allreduce")
    tok = tp1["toks"][:, :1]
    cache = jss.init_cache(smodel, DECODE_BATCH, MAX_LEN)
    jnxt, _, jlogits = _in_mesh_decode(smodel, tree, cache, tok, ctx)
    assert (np.asarray(jnxt) >= vocab).all()
    tmodel = tp1["tsmodel"]
    nxt, logits = tss.decode_forward(
        tmodel.from_jax_params(tree), torch.from_numpy(tok),
        tss.init_cache(tmodel, DECODE_BATCH, MAX_LEN), 0, tmodel,
        TCtx(plan=tfrom_spec("baseline")), return_logits=True)
    assert logits.shape[-1] == table.shape[0]
    np.testing.assert_array_equal(
        nxt.numpy()[:, 0], logits[:, 0, :vocab].argmax(-1).numpy())
    assert rel(logits.numpy(), np.asarray(jlogits)) < TOL["baseline"]


def _in_mesh_decode(model, tree, cache, tok, ctx):
    """One JAX decode step at position 0 on a one-device mesh:
    (next token, cache, logits)."""
    import repro.serve.serve_step as jss
    mesh = _mesh((1, 1, 1), None)
    pspecs, cspecs = model.partition_specs(), jss.cache_pspecs(model)
    f = jax.jit(shard_map(
        lambda q, c, t: jss.decode_forward(q, t, c, jnp.asarray(0), model,
                                           ctx, return_logits=True),
        mesh=mesh, in_specs=(pspecs, cspecs, P()),
        out_specs=(P(), cspecs, P()), check_vma=False))
    return f(jax.tree.map(jnp.asarray, tree), cache, jnp.asarray(tok))


def test_a_seq_axis_is_refused():
    _, tcfg = cfgs(WHISPER)
    with pytest.raises(NotImplementedError, match="encdec/patches"):
        TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu",
               sp_axis="seq", sp=2, sp_rank=0)


def test_launchers_train_and_serve_whisper_smoke(capsys):
    """Both launchers: two taco steps from the pipeline's frame batches;
    three requests served, 3L + 1 hops a token in the wire accounting."""
    from repro_torch.launch import serve, train
    args = train.parse_args(["--arch", WHISPER, "--smoke", "--device",
                             "cpu", "--steps", "2", "--seq", "32",
                             "--batch", "2", "--comm-spec", "taco"])
    trainer, cfg = train.build_trainer(args)
    assert cfg.family == "encdec"
    hist = trainer.run()[2]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    s = serve.main(["--arch", WHISPER, "--smoke", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "4", "--gen", "4",
                    "--max-batch", "2", "--comm-spec", "taco"])
    assert s["requests"] == 3 and s["total_new_tokens"] == 12
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    from repro_torch.serve.engine import _tp_hops_per_token
    assert _tp_hops_per_token(cfg) == 3 * 2 + 1
    assert _tp_hops_per_token(tconfigs.get_config(WHISPER)) == 37


# --------------------------------------------------------------------------
# tp = 2: a gloo world of 2 against the JAX package at 2 host devices
# --------------------------------------------------------------------------

def tp2_inputs(name) -> dict:
    """The weights, batch, decode tokens and cross cache of the tp = 2
    case: the JAX package's seeded draws, which need no device of their
    own (the same bits in the test process and in the subprocess)."""
    model, _ = models(name, 2)
    smodel, _ = models(name, 2, remat=False)
    return {"tree": jax.device_get(model.init(jax.random.PRNGKey(0))),
            "batch": host(batches(name)[0]),
            "toks": decode_tokens(model.cfg.vocab_size),
            "cache": cross_cache(smodel)}


def jax_reference(name, out: str) -> None:
    """The JAX package on two forced host devices at tp = 2: one step's
    loss and grads and a decode's logits under each spec, and the eval
    step over a data group of 2."""
    assert len(jax.devices()) == 2
    model, _ = models(name, 2)
    smodel, _ = models(name, 2, remat=False)
    res = tp2_inputs(name)
    params = jax.tree.map(jnp.asarray, res["tree"])
    jb = {k: jnp.asarray(v) for k, v in res["batch"].items()}
    toks, cache = res["toks"], res["cache"]
    for spec in SPECS:
        res[("step", spec)] = jax_step(model, params, jb, spec, (1, 1, 2))
        res[("decode", spec)] = jax_decode(smodel, params, spec, toks, cache,
                                           (1, 1, 2))
    # the eval step over a data group of 2 (mesh (1, 2, 1))
    dmodel = Model(model.cfg, make_plan(model.cfg, 1, 2))
    res["eval_dp"] = jax_eval(dmodel, params, jb, "baseline", (1, 2, 1))
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def tp2_task(rank, p, group, pl):
    """Each rank of the gloo world: its step and its decode's logits at
    tp = 2, then, the same two processes as a data group of 2 (mesh (1,
    2, 1)), the eval of its rows."""
    from repro_torch.train.train_step import build_eval_step
    _, model = models(pl["name"], 2, rank)
    _, smodel = models(pl["name"], 2, rank, remat=False)
    res = {}
    for spec in SPECS:
        res[("step", spec)] = port_step(model, pl["tree"],
                                        to_port(pl["batch"]), spec, group)
        res[("decode", spec)] = port_decode(smodel, pl["tree"], spec,
                                            pl["toks"], pl["cache"], group)
    tcfg = cfgs(pl["name"])[1]
    dmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 2), device="cpu",
                    fsdp_rank=rank, fsdp_axes=("data",))
    ctx = TCtx(plan=tfrom_spec("baseline"), fsdp_axes=("data",),
               fsdp_groups=(group,))
    res["eval_dp"] = float(build_eval_step(dmodel, ctx)(
        dmodel.from_jax_params(pl["tree"]),
        dmodel.batch_slice(to_port(pl["batch"]))))
    return res


def run_tp2(name, module_file, tmp_path_factory):
    """(the JAX package's results, the port's by rank) at tp = 2: the JAX
    subprocess and the gloo world run side by side
    (:func:`test_torch_dist.beside`) on :func:`tp2_inputs`, which the
    subprocess must have drawn bit for bit alike."""
    from test_torch_dist import beside, run_group
    tmp = tmp_path_factory.mktemp(name)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    inputs = tp2_inputs(name)
    ranks, rc, log = beside(
        [sys.executable, module_file, str(tmp / "jax.pkl")], env,
        tmp / "jax.log", JAX_TIMEOUT_S,
        lambda: run_group(tmp, 2, tp2_task, dict(name=name, **inputs)))
    assert rc == 0, log
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    for key, value in inputs.items():
        for a, b in zip(jax.tree_util.tree_leaves(ref[key]),
                        jax.tree_util.tree_leaves(value), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=key)
    return ref, ranks


def check_tp2_step(name, tp2, spec):
    from repro_torch.optim import adamw
    ref, ranks = tp2
    (l0, g0), (l1, g1) = ranks[0][("step", spec)], ranks[1][("step", spec)]
    assert l0 == l1
    specs = adamw.leaves(models(name, 2)[1].specs())
    check_step((l0, full_grads(specs, [g0, g1])), ref[("step", spec)], spec)


def check_dp_eval(tp2):
    """Each data rank's eval sums its rows' loss and count over the data
    group: every rank holds the global mean, the JAX package's at mesh (1,
    2, 1)."""
    ref, ranks = tp2
    assert ranks[0]["eval_dp"] == ranks[1]["eval_dp"]
    assert abs(ranks[0]["eval_dp"] - ref["eval_dp"]) / ref["eval_dp"] \
        < LOSS_TOL


def check_tp2_decode(tp2, spec):
    ref, ranks = tp2
    port = [np.concatenate([ranks[r][("decode", spec)][t] for r in (0, 1)],
                           axis=-1) for t in range(DECODE_STEPS)]
    check_decode(port, ref[("decode", spec)], spec)


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return run_tp2(WHISPER, __file__, tmp_path_factory)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_tp2_train_step_matches_jax(tp2, spec):
    """The frames are sliced to each rank's half of the encoder's
    sequence with no hop; the replicated leaves' grads are summed over
    the model axis on both ranks alike."""
    check_tp2_step(WHISPER, tp2, spec)


@pytest.mark.parametrize("spec", sorted(TOL))
def test_tp2_decode_matches_jax(tp2, spec):
    check_tp2_decode(tp2, spec)


def test_eval_step_over_a_data_group_matches_jax(tp2):
    check_dp_eval(tp2)


if __name__ == "__main__":
    jax_reference(WHISPER, sys.argv[1])
