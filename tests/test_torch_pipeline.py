"""Pipeline parallelism over a ``pipe x data x model`` mesh of processes,
with TahQuant at the stage boundaries and int8 weight gathers, held
against the JAX package at the same mesh.

One training step of smoke gpt-2.7b cut to 4 layers (d 128, 8 heads of 16,
vocab 503 padded to 512, learned positions, layernorm, gelu; global batch 8 x
seq 32 in 4 microbatches), from the same seeded weights and the same numpy
batch:

  * the port: a gloo world of four spawned processes (as
    ``tests/test_torch_dp.py`` runs it), the pipe mesh's groups built by
    ``launch.mesh.init_mesh(..., axes=PIPE_AXES)``, the weights carried
    across by ``Model.from_jax_params`` (each rank keeps its TP and fsdp
    shard of its stage's layers), the step
    ``train.pipeline_parallel.build_pipeline_train_step``; the sharded
    grads and master weights are reassembled by mesh coordinates;
  * the JAX package: a subprocess with four forced host devices, its
    ``build_pipeline_train_step`` at the same mesh, driven as
    ``tests/multidev/check_pipeline.py`` drives it (the grads are caught on
    their way into ``adamw_update``).

Both compute in f32 (``COMPUTE_DTYPE`` set in both).  The meshes: (2, 2, 1)
and (4, 1, 1) under the identity plan; (2, 1, 2) under ``pp=tahquant`` and
under ``taco3d`` (JAX: ``tp=taco:jnp,...``, its oracle); the pod mesh
(1, 2, 2) under ``weight_ag=int8`` (the unpipelined step).  Each boundary
hop of the compressed runs and each int8 weight gather is held against the
JAX codec on the same per-rank inputs: codes and scales equal (the
quantizer is one f32 division and a round half to even in both packages;
:data:`CODE_FLIPS` is what a tie allows, and none is measured).

Bounds, relative, loss / flattened grads / updated master weights.
Identity plan: 1e-6 / 1e-5 / 1e-5, ``tests/test_torch_dp.py``'s; measured
7.6e-8 / 4.5e-7 / 1.3e-6 at (2, 2, 1) and 0 / 5.4e-7 / 1.7e-6 at
(4, 1, 1).  ``weight_ag=int8``: the same bounds, since both packages
quantize the same weights to the same codes; measured 0 / 4.5e-7 /
1.1e-6.  Under ``pp=tahquant`` and ``taco3d`` the per-rank inputs of a
hop differ by the float reassociation of the two packages (~1e-7), and a
code on the other side of a rounding boundary moves its element by a
whole code step, so the bounds are set from what is measured
(:data:`PP_BOUNDS`):

  * ``pp=tahquant``: measured 2.3e-7 / 1.7e-4 / 1.9e-4; bounds 1e-6 /
    1e-3 / 1e-3.  The codec itself moves the master weights 1.6e-3 from
    the identity plan's.
  * ``taco3d``: measured 6.1e-6 / 1.05e-1 / 1.08e-2.  F2's 7.5e-2 gradient
    bound (``ROADMAP.md`` §3) cannot hold here: SDP4bit quantizes every
    weight gradient of every tick to int4, and a TACO code flipped by a
    last-bit difference moves the gradients of its block across int4
    steps.  The port against itself with its rotations as one f32 matmul
    (TACO's plain compress through ``ash.ash_forward`` for it) spreads
    5.8e-5 / 9.8e-2 / 1.03e-2 (the JAX package's taco3d against its
    identity plan: 1.3e-1 of the grads, 1.08e-2 of the weights), so the
    bounds are about twice that spread: 1e-4 / 2e-1 / 2e-2
    (:func:`test_taco3d_rotations_last_bit_spreads_as_far`).  What holds
    the codecs to the reference there is the hop-by-hop check: every
    boundary hop, and every SDP4bit and TACO hop of the step
    (:func:`test_taco3d_sdp4bit_and_taco_hops_match_jax`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dist import rel, run_group
from test_torch_dist_ref import _f32
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ, BATCH, MICRO, LAYERS = 32, 8, 4, 4
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)
ID_MESHES = ((2, 2, 1), (4, 1, 1))
PP_MESH = (2, 1, 2)
POD_MESH = (1, 2, 2)
#: the port's spec -> the JAX package's (its TACO oracle, as check_pipeline)
PP_SPECS = {"pp=tahquant": "pp=tahquant",
            "taco3d": "tp=taco:jnp,grad_rs=sdp4bit,pp=tahquant"}
INT8 = "weight_ag=int8"
#: taco3d with the port's rotations (TACO's plain rotation and SDP4bit's)
#: as one f32 matmul: the spread the PP_BOUNDS are set from
F32_ROTATION = "taco3d f32-rotation"
RUNS = tuple((s, "baseline") for s in ID_MESHES) + \
    tuple((PP_MESH, s) for s in PP_SPECS)
#: (loss, grads, master weights) relative bounds of the identity plan
IDENTITY_BOUNDS = (1e-6, 1e-5, 1e-5)
#: (loss, grads, master weights) under pp=tahquant and taco3d (module
#: docstring)
PP_BOUNDS = {"pp=tahquant": (1e-6, 1e-3, 1e-3),
             "taco3d": (1e-4, 2e-1, 2e-2)}
#: how far each codec at least moves the master weights from the identity
#: plan's (measured 1.6e-3 and 1.08e-2): the codec ran
CODEC_MOVES = {"pp=tahquant": 5e-4, "taco3d": 5e-3}
#: codes of one comparison that may differ, at ties only
CODE_FLIPS = 0
JAX_TIMEOUT_S = 300


def _perms(p):
    """The forward chain of the pipeline (stage 0 receives nothing) and a
    ring (everyone receives)."""
    return {"chain": tuple((i, i + 1) for i in range(p - 1)),
            "ring": tuple((i, (i + 1) % p) for i in range(p))}


def _pp_inputs(p):
    """Per-stage inputs (p, 2, 9, 40) and cotangents of the ppermute check:
    720 elements a rank, padded to 768 by the 64-group codec."""
    gen = np.random.default_rng(40 + p)
    x = gen.normal(0.0, 1.0, (p, 2, 9, 40)).astype(np.float32)
    x[:, 0, 0, :8] *= 30.0                                # outliers
    ct = gen.normal(0.0, 1e-2, (p, 2, 9, 40)).astype(np.float32)
    return x, ct


def _jcfg():
    from repro.configs import get_config, smoke_config
    return dataclasses.replace(smoke_config(get_config("gpt-2.7b")),
                               n_layers=LAYERS)


def _pcfg():
    from repro_torch.configs import get_config, smoke_config
    return dataclasses.replace(smoke_config(get_config("gpt-2.7b")),
                               n_layers=LAYERS)


def jax_reference(out: str) -> None:
    """The JAX package on four forced host devices: ``ppermute_c`` at
    pipe 2 and 4, its pipeline step at every mesh of :data:`RUNS`, and its
    unpipelined step at :data:`POD_MESH` under :data:`INT8`."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    import repro.train.pipeline_parallel as jpl
    from repro import compat
    from repro.compat import shard_map
    from repro.configs import make_plan
    from repro.core import collectives as jcc
    from repro.core.parallel import ParallelCtx
    from repro.core.registry import codec_from_spec, from_spec
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.train.train_step import dp_axes
    for mod in (jl, ja, jt, jpl):
        mod.COMPUTE_DTYPE = jnp.float32
    assert len(jax.devices()) == 4
    res = {}
    for p in (2, 4):
        mesh = compat.make_mesh((p,), ("pipe",), devices=jax.devices()[:p])
        x, ct = _pp_inputs(p)
        for spec in ("none", "tahquant"):
            codec = codec_from_spec(spec)
            for name, perm in _perms(p).items():
                def f(xl, cl, perm=perm, codec=codec):
                    y, vjp = jax.vjp(lambda a: jcc.ppermute_c(
                        a, "pipe", perm, codec, codec), xl)
                    return y, vjp(cl)[0]
                g = jax.jit(shard_map(f, mesh=mesh,
                                      in_specs=(PS("pipe"), PS("pipe")),
                                      out_specs=(PS("pipe"), PS("pipe")),
                                      check_vma=False))
                y, gx = g(x, ct)
                res[("pp", p, spec, name)] = (np.asarray(y), np.asarray(gx))
    cfg = _jcfg()
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    res["batch"] = {k: np.asarray(v) for k, v in batch.items()}
    oc = adamw.OptConfig(**OPT)
    update = adamw.adamw_update

    def spy(grads, opt_state, oc, model):
        # the grads leave the step in place of the new bf16 params
        return (grads,) + tuple(update(grads, opt_state, oc, model)[1:])
    leaves = jax.tree_util.tree_leaves
    for shape, spec in RUNS:
        pipe, data, tp = shape
        mesh = compat.make_mesh(shape, ("pipe", "data", "model"))
        model = Model(cfg, make_plan(cfg, tp, data), fsdp_axes=("data",),
                      tp_axis="model")
        ctx = ParallelCtx(tp_axis="model", fsdp_axes=("data",),
                          plan=from_spec(PP_SPECS.get(spec, spec)))
        pc = jpl.PipeConfig(stages=pipe, microbatches=MICRO)
        adamw.adamw_update = spy
        try:
            step = jpl.build_pipeline_train_step(model, mesh, ctx, oc, pc)
            params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
            params = jax.tree.map(lambda a, s: jax.device_put(
                a, NamedSharding(mesh, s)), params,
                jpl.pipe_partition_specs(model, pc))
            bspecs = model.batch_pspecs()
            b = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                 for k, v in batch.items()}
            grads, opt, m = step(params, adamw.init_opt_state(params), b)
        finally:
            adamw.adamw_update = update
        res[(shape, spec)] = (
            float(m["loss"]), [np.asarray(g, np.float32) for g in leaves(grads)],
            [np.asarray(w, np.float32) for w in leaves(opt["master"])],
            float(m["grad_norm"]),
            np.vectorize(lambda d: d.id)(mesh.devices))
    # the unpipelined step on the pod mesh under weight_ag=int8
    pod, data, tp = POD_MESH
    mesh = compat.make_mesh(POD_MESH, ("pod", "data", "model"))
    model = Model(cfg, make_plan(cfg, tp, pod * data))
    pspecs, bspecs = model.partition_specs(), model.batch_pspecs()
    ospecs = adamw.opt_state_pspecs(pspecs)
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    ctx = ParallelCtx(plan=from_spec(INT8))

    def step(q, o, b):
        def loss_fn(qq):
            loss_sum, count, _ = model.loss_parts(qq, b, ctx)
            loss_sum = jcc.psum_exact(loss_sum, dp_axes(model))
            count = jax.lax.psum(jax.lax.stop_gradient(count), dp_axes(model))
            return loss_sum / jnp.maximum(count, 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(q)
        grads = adamw.finalize_grads(grads, model)
        _, new, m = adamw.adamw_update(grads, o, oc, model)
        return loss, grads, new["master"], m["grad_norm"]
    f = jax.jit(shard_map(step, mesh=mesh, in_specs=(pspecs, ospecs, bspecs),
                          out_specs=(PS(), pspecs, pspecs, PS()),
                          check_vma=False))

    def put(tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), tree, specs)
    loss, grads, master, gnorm = f(
        put(params, pspecs), put(adamw.init_opt_state(params), ospecs),
        {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
         for k, v in batch.items()})
    res[(POD_MESH, INT8)] = (
        float(loss), [np.asarray(g, np.float32) for g in leaves(grads)],
        [np.asarray(w, np.float32) for w in leaves(master)], float(gnorm))
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


# --------------------------------------------------------------------------
# the port, on every rank
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _recording(pp_hops, ag_hops, ctx=None, sdp_hops=None, tp_hops=None):
    """Within the block, each compressed boundary hop (``_pp_impl``)
    appends ``(perm, input, output)`` to ``pp_hops``, and each one-group
    hop of an fsdp weight gather under ``Int8Codec`` appends ``(axis, dim,
    input, output)`` to ``ag_hops`` (the axis by the group's place in
    ``ctx.fsdp_groups``).  On a pipe mesh (one fsdp axis, ``data``), with
    the lists given, each one-group hop under ``Sdp4BitCodec`` over the
    data group appends ``("data", kind, dim, input, output)`` to
    ``sdp_hops`` (``tests/test_torch_dp.py``'s record), and each TP hop
    under ``TacoCodec`` appends ``(kind, dim, input, output)`` to
    ``tp_hops`` (``tests/test_torch_dist_ref.py``'s)."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.codecs import (IdentityCodec, Int8Codec,
                                         Sdp4BitCodec, TacoCodec)
    pp, ag = cc._pp_impl, cc._ag_one
    saved = {n: getattr(cc, n)
             for n in ("_rs_one", "_ag_impl", "_rs_impl")}
    if sdp_hops is not None:
        def sdp_rec(x, group, dim, codec):
            out = saved["_rs_one"](x, group, dim, codec)
            if isinstance(codec, Sdp4BitCodec):
                assert ctx.fsdp_axes == ("data",)
                assert group is ctx.fsdp_groups[0]
                sdp_hops.append(("data", "rs", dim,
                                 x.detach().float().numpy().copy(),
                                 out.detach().float().numpy().copy()))
            return out
        cc._rs_one = sdp_rec
    if tp_hops is not None:
        for name in ("_ag_impl", "_rs_impl"):
            def tp_rec(x, group, dim, codec, _impl=saved[name],
                       _kind=name[1:3]):
                out = _impl(x, group, dim, codec)
                if isinstance(codec, TacoCodec):
                    tp_hops.append((_kind, dim, x.detach().numpy().copy(),
                                    out.detach().numpy().copy()))
                return out
            setattr(cc, name, tp_rec)

    def pp_rec(x, group, perm, codec):
        out = pp(x, group, perm, codec)
        if not isinstance(codec, IdentityCodec):
            pp_hops.append((perm, x.detach().numpy().copy(),
                            out.detach().numpy().copy()))
        return out

    def ag_rec(x, group, dim, codec):
        out = ag(x, group, dim, codec)
        if isinstance(codec, Int8Codec):
            axis = [g is group for g in ctx.fsdp_groups].index(True)
            ag_hops.append((ctx.fsdp_axes[axis], dim,
                            x.detach().numpy().copy(),
                            out.detach().numpy().copy()))
        return out
    cc._pp_impl, cc._ag_one = pp_rec, ag_rec
    try:
        yield
    finally:
        cc._pp_impl, cc._ag_one = pp, ag
        for name, fn in saved.items():
            setattr(cc, name, fn)


def _caught_step(build, model, ctx, tree, batch):
    """One step of ``build(model, ctx, oc)``: (loss, grad norm, finalized
    grads, master weights after the update), the grads caught on their way
    into AdamW."""
    from repro_torch.optim import adamw
    params = model.from_jax_params(tree)
    caught = {}
    update = adamw.adamw_update

    def spy(params, grads, *a, **k):
        caught["grads"] = [g.float().numpy().copy()
                           for g in adamw.leaves(grads)]
        return update(params, grads, *a, **k)
    adamw.adamw_update = spy
    try:
        step = build(model, ctx, adamw.OptConfig(**OPT))
        _, opt, m = step(params, adamw.init_opt_state(params), batch)
    finally:
        adamw.adamw_update = update
    return (float(m["loss"]), float(m["grad_norm"]), caught["grads"],
            [w.numpy().copy() for w in adamw.leaves(opt["master"])])


def _pipe_build(stages):
    from repro_torch.train import pipeline_parallel as pl

    def build(model, ctx, oc):
        return pl.build_pipeline_train_step(
            model, ctx, oc, pl.PipeConfig(stages=stages, microbatches=MICRO))
    return build


def _model(tp, fsdp, **kw):
    from repro_torch import configs
    from repro_torch.models.model import Model
    cfg = _pcfg()
    return Model(cfg, configs.make_plan(cfg, tp, fsdp), device="cpu", **kw)


def _pipe_task(rank, p, group, pl):
    from repro_torch.core import ash
    from repro_torch.core import collectives as cc
    from repro_torch.core.registry import codec_from_spec, from_spec
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import PIPE_AXES, init_mesh
    from repro_torch.train.train_step import build_train_step
    _f32()
    res = {}
    for pp in (2, 4):
        mesh = init_mesh((pp, 4 // pp, 1), "cpu", axes=PIPE_AXES)
        i, g = mesh.index("pipe"), mesh.groups["pipe"]
        x, ct = _pp_inputs(pp)
        for spec in ("none", "tahquant"):
            c = codec_from_spec(spec)
            for name, perm in _perms(pp).items():
                xi = torch.from_numpy(x[i]).requires_grad_(True)
                y = cc.ppermute_c(xi, g, perm, c, c)
                y.backward(torch.from_numpy(ct[i]))
                res[("pp", pp, spec, name)] = (y.detach().numpy(),
                                               xi.grad.numpy())
    glob = {k: torch.from_numpy(v) for k, v in pl["batch"].items()}
    for shape, spec in RUNS + ((PP_MESH, F32_ROTATION),):
        mesh = init_mesh(shape, "cpu", axes=PIPE_AXES)
        ctx = mesh.parallel_ctx(from_spec(spec.split(" ")[0]))
        model = _model(shape[2], shape[1], **mesh.model_kwargs())
        hops = []
        # the taco3d step's SDP4bit and TACO hops, held in this process
        sdp, tp = ([], []) if spec == "taco3d" else (None, None)
        rotate, plain_bits = ash._rotate, ref.plain_bits
        if spec == F32_ROTATION:
            # TACO's plain compress through ash.ash_forward, so that its
            # rotation is the f32 matmul too
            ash._rotate = lambda z, h: z @ h
            ref.plain_bits = lambda cfg: False
        try:
            with _recording(hops, [], ctx, sdp, tp):
                out = _caught_step(_pipe_build(shape[0]), model, ctx,
                                   pl["trees"][shape[2]],
                                   model.batch_slice(glob))
        finally:
            ash._rotate, ref.plain_bits = rotate, plain_bits
        res[(shape, spec)] = out + (hops, mesh.coords, sdp, tp)
    mesh = init_mesh(POD_MESH, "cpu")
    ctx = mesh.parallel_ctx(from_spec(INT8))
    model = _model(POD_MESH[2], POD_MESH[0] * POD_MESH[1],
                   **mesh.model_kwargs())
    hops = []
    with _recording([], hops, ctx):
        out = _caught_step(build_train_step, model, ctx, pl["trees"][2],
                           model.batch_slice(glob))
    res[(POD_MESH, INT8)] = out + (hops, mesh.coords)
    return res


# --------------------------------------------------------------------------
# reassembly and the references in this process
# --------------------------------------------------------------------------

def _specs_and_stacked(tp, fsdp):
    """The global specs' leaves, and which are leaves of the layer stack."""
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    specs = _model(tp, fsdp).specs()
    flags = {k: tree_map(lambda _, k=k: k == "segments", v)
             for k, v in specs.items()}
    return adamw.leaves(specs), adamw.leaves(flags)


def _global(shape, per_rank, axes="pipe"):
    """Global leaves from per-rank shard leaves (``per_rank[r][i]``) of a
    pipe mesh (``axes="pipe"``: stages of a stack concatenated along dim
    0, the rest taken from stage 0, fsdp over data) or of the pod mesh
    (fsdp pod-major over pod x data): TP shards concatenated along
    ``tp_dim``, fsdp shards along ``fsdp_dim``."""
    from repro_torch.launch.mesh import mesh_rank
    if axes == "pipe":
        stages, fsdp, tp = shape
    else:
        stages, fsdp, tp = 1, shape[0] * shape[1], shape[2]
    d = shape[1]
    specs, stacked = _specs_and_stacked(tp, fsdp)
    out = []
    for i, spec in enumerate(specs):
        pieces = []
        for st in range(stages if stacked[i] else 1):
            rows = []
            for f in range(fsdp if spec.fsdp_dim is not None else 1):
                cols = []
                for m in range(tp if spec.tp_dim is not None else 1):
                    coords = (st, f, m) if axes == "pipe" else (f // d, f % d, m)
                    cols.append(per_rank[mesh_rank(coords, shape)][i])
                rows.append(cols[0] if len(cols) == 1
                            else np.concatenate(cols, axis=spec.tp_dim))
            pieces.append(rows[0] if len(rows) == 1
                          else np.concatenate(rows, axis=spec.fsdp_dim))
        out.append(pieces[0] if len(pieces) == 1
                   else np.concatenate(pieces, axis=0))
    return out


def _flat(leaves):
    return np.concatenate([a.ravel() for a in leaves])


def _stage_norms(shape, grads):
    """Each stage's clip norm from global grads: its own layers of every
    stack leaf and every other leaf whole (the JAX package's
    ``global_grad_norm`` on that stage)."""
    _, stacked = _specs_and_stacked(shape[2], shape[1])
    stages = shape[0]
    out = []
    for st in range(stages):
        sq = 0.0
        for g, is_stack in zip(grads, stacked):
            if is_stack:
                per = g.shape[0] // stages
                g = g[st * per:(st + 1) * per]
            sq += float(np.sum(g.astype(np.float64) ** 2))
        out.append(np.sqrt(sq))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX package's runs (a subprocess) and the port's (a gloo world of
    four processes), started together."""
    tmp = tmp_path_factory.mktemp("pipe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with subprocess.Popen([sys.executable, __file__, str(tmp / "jax.pkl")],
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        try:
            import jax
            from repro.configs import make_plan
            from repro.data.pipeline import DataConfig, SyntheticLM
            from repro.models.model import Model
            cfg = _jcfg()
            batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH),
                                cfg).batch(0)
            nb = {k: np.asarray(v).astype(np.float32 if k == "mask"
                                          else np.int64)
                  for k, v in batch.items()}
            trees = {tp: jax.device_get(Model(cfg, make_plan(cfg, tp, 1))
                                        .init(jax.random.PRNGKey(0),
                                              dtype=jnp.float32))
                     for tp in (1, 2)}
            port = run_group(tmp, 4, _pipe_task, {"trees": trees,
                                                   "batch": nb})
            log, _ = proc.communicate(timeout=JAX_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    for k, v in ref["batch"].items():
        np.testing.assert_array_equal(nb[k], v.astype(nb[k].dtype))
    return ref, port


# --------------------------------------------------------------------------
# (a)-(c): the codecs and the grammar against the JAX package, in process
# --------------------------------------------------------------------------

def _codec_inputs(seed, shape=(3, 1024)):
    """Rows of normal values, heavy tails, a group under the scale floor
    (max 1e-28: s = 1e-30), an all-zero group and a group of exact ties
    (max 127, so s = 1 and z / s = k + 0.5); no subnormals."""
    gen = np.random.default_rng(seed)
    x = gen.normal(0.0, 1.0, shape).astype(np.float32)
    x[0, :64] = gen.standard_t(2, 64).astype(np.float32) * 10
    x[1, :128] = gen.normal(0.0, 1e-28, 128).astype(np.float32)
    x[1, 128:256] = 0.0
    x[2, :128] = np.concatenate([[127.0], np.arange(-63, 64) + 0.5])
    assert not np.any((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))
    return x


@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pp_compress_matches_jax(group, dtype):
    """(a) ``compress_int8_group`` / ``decompress_int8_group`` /
    ``decompress_sum_int8_group`` against the JAX package's, compiled as a
    training step compiles them (``jax.jit``), on the same input: codes,
    scales and decodes bit for bit (the peer sum of three peers within two
    ulps of its terms' magnitude: XLA's reduction order).  Called op by op, the JAX
    package divides ``max|z| / 127`` where its compiled program multiplies
    by ``f32(1/127)``: its scales then differ from the port's (and from
    its own compiled ones) by at most one f32 rounding."""
    import jax

    from repro.core import pp_compress as jpp
    from repro_torch.core import pp_compress as tpp
    x = torch.from_numpy(_codec_inputs(group))
    x = x.to(getattr(torch, dtype))
    xj = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    n = x.shape[-1]
    q, s = tpp.compress_int8_group(x, group)
    jq, js = jax.jit(jpp.compress_int8_group, static_argnums=1)(xj, group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _, eager = jpp.compress_int8_group(xj, group)
    np.testing.assert_allclose(s.numpy(), np.asarray(eager), rtol=1.2e-7,
                               atol=0)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert float(s.min()) >= 1e-30
    d = tpp.decompress_int8_group(q, s, n, group, torch.float32)
    jd = jax.jit(jpp.decompress_int8_group, static_argnums=(2, 3, 4))(
        jq, js, n, group, jnp.float32)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    ds = tpp.decompress_sum_int8_group(q, s, n, group, torch.float32)
    jds = np.asarray(jax.jit(jpp.decompress_sum_int8_group,
                             static_argnums=(2, 3, 4))(
        jq, js, n, group, jnp.float32))
    # another summation order (and XLA may fuse the products into it):
    # within two ulps of the terms' magnitude
    mag = np.abs(d.numpy()).sum(axis=0)
    assert np.all(np.abs(ds.numpy() - jds) <= 2 * 2.0 ** -23 * mag)
    # the ties: round half to even, 127 -> s = 1
    if group == 128 and dtype == "float32":
        assert float(s[2, 0]) == 1.0
        half = np.arange(-63, 64) + 0.5
        want = np.round(half)                       # numpy: half to even
        np.testing.assert_array_equal(q[2, 1:128].numpy(), want)


@pytest.mark.parametrize("spec", ["tahquant", "int8", "tahquant:g32",
                                  "int8:g64"])
@pytest.mark.parametrize("n", [1024, 1920])
def test_codec_wire_crosses_packages(spec, n):
    """(a) and (b) ``TahQuantCodec`` / ``Int8Codec``: the layout, the
    granule and the bytes per element are the JAX package's; a wire row
    packed by either package (the JAX codec compiled) equals the other's
    byte for byte and decodes in the other bit for bit (the peer sum of a
    three-peer stack within two ulps, XLA's summation order)."""
    import jax

    from repro.core.registry import codec_from_spec as jfrom
    from repro_torch.core.registry import codec_from_spec
    c, jc = codec_from_spec(spec), jfrom(spec)
    assert c.granule == jc.granule
    assert c.bytes_per_element() == jc.bytes_per_element()
    assert [(f.name, f.dtype, f.size, f.offset)
            for f in c.wire_layout(n).components] == \
        [(f.name, np.dtype(f.dtype).name, f.size, f.offset)
         for f in jc.wire_layout(n).components]
    x = _codec_inputs(n, (3, n))
    wire = c.encode_wire(torch.from_numpy(x))
    jwire = np.array(jax.jit(jc.encode_wire)(jnp.asarray(x)))
    assert wire.dtype == torch.uint8
    assert wire.shape == (3, c.wire_layout(n).total_bytes)
    np.testing.assert_array_equal(wire.numpy(), jwire)
    mine = c.decode_wire(torch.from_numpy(jwire), n, torch.float32).numpy()
    theirs = np.asarray(jax.jit(jc.decode_wire, static_argnums=(1, 2))(
        jnp.asarray(wire.numpy()), n, jnp.float32))
    np.testing.assert_array_equal(mine, theirs)
    summed = c.decode_sum_wire(torch.from_numpy(jwire), n,
                               torch.float32).numpy()
    jsummed = np.asarray(jax.jit(jc.decode_sum_wire, static_argnums=(1, 2))(
        jnp.asarray(wire.numpy()), n, jnp.float32))
    # the summation order, as test_pp_compress_matches_jax
    assert np.all(np.abs(summed - jsummed) <=
                  2 * 2.0 ** -23 * np.abs(mine).sum(axis=0))


@pytest.mark.parametrize("spec", ["pp=tahquant", "pp=tahquant:g32",
                                  "weight_ag=int8:g64:chunks=2",
                                  "pp=tahquant,weight_ag=int8", "taco3d"])
def test_grammar_matches_jax(spec):
    """(c) Each spec parses, and ``to_spec`` is the JAX package's."""
    from repro.core import registry as jreg
    from repro_torch.core import registry as reg
    from repro_torch.core.codecs import Int8Codec, TahQuantCodec
    plan = reg.from_spec(spec)
    assert reg.to_spec(plan) == jreg.to_spec(jreg.from_spec(spec))
    assert reg.from_spec(reg.to_spec(plan)) == plan
    assert isinstance(plan.pp, TahQuantCodec) or \
        isinstance(plan.weight_ag, Int8Codec)


# --------------------------------------------------------------------------
# (d)-(f), (i): against the JAX package at the same mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("spec", ["none", "tahquant"])
@pytest.mark.parametrize("perm", ["chain", "ring"])
def test_ppermute_matches_jax(both, p, spec, perm):
    """(d) ``ppermute_c`` forward and backward on a pipe group of ``p``
    ranks against the JAX package's on ``p`` devices, the same per-stage
    inputs: bit for bit; under the chain, stage 0 receives zeros and the
    last stage's input gets a zero gradient."""
    ref, port = both
    from repro_torch.launch.mesh import PIPE_AXES, mesh_coords
    y_ref, g_ref = ref[("pp", p, spec, perm)]
    shape = (p, 4 // p, 1)
    for r in range(4):
        i = mesh_coords(r, shape)[PIPE_AXES.index("pipe")]
        y, g = port[r][("pp", p, spec, perm)]
        np.testing.assert_array_equal(y, y_ref[i])
        np.testing.assert_array_equal(g, g_ref[i])
        if perm == "chain" and i == 0:
            assert not y.any()
        if perm == "chain" and i == p - 1:
            assert not g.any()
    x, _ = _pp_inputs(p)
    if spec == "none":
        np.testing.assert_array_equal(y_ref[1], x[0])


@pytest.mark.parametrize("shape", ID_MESHES, ids=["2x2x1", "4x1x1"])
def test_identity_pipeline_step_matches_jax(both, shape):
    """(e) The identity plan: the loss, the reassembled grads and master
    weights against the JAX package's; every stage's clip norm against the
    reference's rule (its own layers and the replicated parameters), and
    stage 0's against the norm the reference's step reports."""
    ref, port = both
    from repro_torch.launch.mesh import PIPE_AXES, mesh_coords
    loss_b, grad_b, master_b = IDENTITY_BOUNDS
    jl_, jgrads, jmaster, jgnorm, devices = ref[(shape, "baseline")]
    runs = [port[r][(shape, "baseline")] for r in range(4)]
    for r in range(4):
        assert runs[r][5] == mesh_coords(r, shape)
        assert devices[runs[r][5]] == r             # jax.make_mesh's order
    assert len({run[0] for run in runs}) == 1       # every rank agrees
    assert abs(runs[0][0] - jl_) / abs(jl_) < loss_b, (runs[0][0], jl_)
    grads = _global(shape, [run[2] for run in runs])
    assert [g.shape for g in grads] == [g.shape for g in jgrads]
    assert rel(_flat(grads), _flat(jgrads)) < grad_b
    master = _global(shape, [run[3] for run in runs])
    assert rel(_flat(master), _flat(jmaster)) < master_b
    norms = _stage_norms(shape, jgrads)
    assert abs(norms[0] - jgnorm) / jgnorm < grad_b
    stage = PIPE_AXES.index("pipe")
    for run in runs:
        want = norms[run[5][stage]]
        assert abs(run[1] - want) / want < grad_b, (run[1], want)
    assert len({round(n, 4) for n in norms}) == shape[0]   # per stage


def _codes_scales(wire, n):
    """The int8 codes and the f32 scales of packed wire rows."""
    q = wire[..., :n].view(np.int8)
    s = wire[..., n:].copy().view(np.float32)
    return q, s


def _check_pp_hops(shape, runs):
    """Every boundary hop of the step, on every pipe group: the sender's
    recorded input through the port's and the JAX codec (codes and scales
    equal), and the receiver's recorded output the port's decode of the
    sender's wire bit for bit; a rank no pair sends to got zeros.  Returns
    (hops, codes)."""
    from repro.core.registry import codec_from_spec as jfrom
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.launch.mesh import PIPE_AXES, axis_ranks
    import jax
    c, jc = codec_from_spec("tahquant"), jfrom("tahquant")
    jencode = jax.jit(jc.encode_wire)
    hops = [run[4] for run in runs]
    assert len({len(h) for h in hops}) == 1 and hops[0]
    codes = 0
    for k in range(len(hops[0])):
        perm = hops[0][k][0]
        for ranks in axis_ranks(shape, "pipe", PIPE_AXES):
            assert all(hops[r][k][0] == perm for r in ranks)
            got = {d: hops[ranks[d]][k][2] for d in range(len(ranks))}
            for src, dst in perm:
                x = hops[ranks[src]][k][1]
                row = torch.from_numpy(x.reshape(1, -1))
                n = row.shape[-1]
                padded = torch.nn.functional.pad(row, (0, (-n) % c.group))
                wire = c.encode_wire(padded).numpy()
                jwire = np.asarray(jencode(jnp.asarray(padded.numpy())))
                pn = padded.shape[-1]
                q, s = _codes_scales(wire, pn)
                jq, js = _codes_scales(jwire, pn)
                assert int(np.sum(q != jq)) <= CODE_FLIPS
                np.testing.assert_array_equal(s, js)
                codes += q.size
                dec = c.decode_wire(torch.from_numpy(wire), pn,
                                    torch.float32)[..., :n]
                np.testing.assert_array_equal(
                    got.pop(dst), dec.numpy().reshape(x.shape))
            for rest in got.values():
                assert not rest.any()
    return len(hops[0]), codes


@pytest.mark.parametrize("spec", list(PP_SPECS))
def test_compressed_pipeline_step_matches_jax(both, spec):
    """(f) At (2, 1, 2) under ``pp=tahquant`` and ``taco3d``: every
    boundary hop (M + P - 1 = 5 forward, 4 backward, on both pipe groups)
    against the JAX codec; the loss, grads and master weights against the
    JAX package's within :data:`PP_BOUNDS` (module docstring), and away
    from the identity plan's by :data:`CODEC_MOVES`."""
    ref, port = both
    shape = PP_MESH
    runs = [port[r][(shape, spec)] for r in range(4)]
    hops, codes = _check_pp_hops(shape, runs)
    assert hops == 9 and codes > 0
    loss_b, grad_b, master_b = PP_BOUNDS[spec]
    jl_, jgrads, jmaster, _, _ = ref[(shape, spec)]
    assert len({run[0] for run in runs}) == 1
    assert abs(runs[0][0] - jl_) / abs(jl_) < loss_b, (runs[0][0], jl_)
    grads = _global(shape, [run[2] for run in runs])
    assert rel(_flat(grads), _flat(jgrads)) < grad_b
    master = _global(shape, [run[3] for run in runs])
    assert rel(_flat(master), _flat(jmaster)) < master_b
    base = _global((2, 2, 1), [port[r][((2, 2, 1), "baseline")][3]
                               for r in range(4)])
    assert rel(_flat(master), _flat(base)) > CODEC_MOVES[spec]


def test_taco3d_sdp4bit_and_taco_hops_match_jax(both):
    """(f) Inside the ``taco3d`` step at (2, 1, 2), on every rank: every
    SDP4bit weight-gradient hop (the data stage, of one rank) against the
    jitted JAX codec on the same input, to the parity rule of
    ``core/dp_compress.py`` as ``tests/test_torch_dp.py`` holds it (codes
    at most one apart, flips away from ties under 1e-4 of the codes, the
    hop's output the port's decode bit for bit); every TACO hop over each
    TP group against the JAX codec (its ``jnp`` oracle) on the same
    per-rank inputs within ``tests/test_torch_dist_ref.py``'s
    ``HOP_BOUND``.  These hold the codecs where the step's bounds
    (:data:`PP_BOUNDS`) are too wide to."""
    from test_torch_dist import _jax_ag, _jax_codec, _jax_rs
    from test_torch_dist_ref import HOP_BOUND
    from test_torch_dp import _check_hops
    from repro_torch.launch.mesh import PIPE_AXES, axis_ranks
    _, port = both
    runs = [port[r][(PP_MESH, "taco3d")] for r in range(4)]
    tally = dict(codes=0, flipped=0, at_ties=0, hops=0)
    _check_hops(PP_MESH, [run[6] for run in runs], tally, PIPE_AXES)
    assert tally["hops"] == 4 * len(runs[0][6]) > 0
    assert tally["flipped"] - tally["at_ties"] <= 1e-4 * tally["codes"], \
        tally
    hops = [run[7] for run in runs]
    assert len({len(h) for h in hops}) == 1 and hops[0]
    codec = _jax_codec("taco")
    for ranks in axis_ranks(PP_MESH, "model", PIPE_AXES):
        for k, (kind, dim, _, _) in enumerate(hops[ranks[0]]):
            assert dim == 1 and all(hops[r][k][:2] == (kind, dim)
                                    for r in ranks)
            xs = [hops[r][k][2] for r in ranks]
            want = ([_jax_ag(xs, codec)] * len(ranks) if kind == "ag"
                    else _jax_rs(xs, codec))
            for i, r in enumerate(ranks):
                err = rel(hops[r][k][3], want[i])
                assert err < HOP_BOUND, (k, kind, r, err)


def test_taco3d_rotations_last_bit_spreads_as_far(both):
    """The port's taco3d step against itself with its rotations (TACO's
    plain rotation and SDP4bit's) as one f32 matmul stays within
    :data:`PP_BOUNDS` / 1.5: the measurement the bounds are set from."""
    _, port = both
    a = [port[r][(PP_MESH, "taco3d")] for r in range(4)]
    b = [port[r][(PP_MESH, F32_ROTATION)] for r in range(4)]
    bounds = PP_BOUNDS["taco3d"]
    assert abs(a[0][0] - b[0][0]) / a[0][0] < bounds[0] / 1.2
    for i, bound in zip((2, 3), bounds[1:]):
        spread = rel(_flat(_global(PP_MESH, [r[i] for r in a])),
                     _flat(_global(PP_MESH, [r[i] for r in b])))
        assert 0 < spread < bound / 1.5, (i, spread)


def test_int8_weight_gathers_match_jax(both):
    """(i) ``weight_ag=int8`` on the pod mesh (1, 2, 2): every weight
    gather hop (data, then pod, at every use) against the JAX codec on the
    same per-rank inputs — codes and scales equal — and its output the
    port's decode of the gathered wires bit for bit; the loss, grads and
    master weights against the JAX package's within the identity bounds."""
    ref, port = both
    from repro.core.registry import codec_from_spec as jfrom
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.launch.mesh import AXES, axis_ranks
    import jax
    c, jc = codec_from_spec("int8"), jfrom("int8")
    jencode = jax.jit(jc.encode_wire)
    runs = [port[r][(POD_MESH, INT8)] for r in range(4)]
    hops = [run[4] for run in runs]
    assert len({len(h) for h in hops}) == 1
    assert [h[0] for h in hops[0]][:2] == ["data", "pod"]
    codes = 0
    for k, (axis, dim, _, _) in enumerate(hops[0]):
        for ranks in axis_ranks(POD_MESH, axis, AXES):
            rows = [torch.from_numpy(hops[r][k][2].reshape(1, -1))
                    for r in ranks]
            n = rows[0].shape[-1]
            padded = [torch.nn.functional.pad(r, (0, (-n) % c.group))
                      for r in rows]
            pn = padded[0].shape[-1]
            wires = torch.cat([c.encode_wire(r) for r in padded])
            jwires = np.concatenate([np.asarray(jencode(
                jnp.asarray(r.numpy()))) for r in padded])
            q, s = _codes_scales(wires.numpy(), pn)
            jq, js = _codes_scales(jwires, pn)
            assert int(np.sum(q != jq)) <= CODE_FLIPS
            np.testing.assert_array_equal(s, js)
            codes += q.size
            dec = c.decode_wire(wires, pn, torch.float32)[:, :n]
            x = hops[ranks[0]][k][2]
            stacked = dec.numpy().reshape(len(ranks), *x.shape)
            size = list(x.shape)
            size[dim] *= len(ranks)
            want = np.moveaxis(stacked, 0, dim).reshape(size)
            for r in ranks:
                np.testing.assert_array_equal(hops[r][k][3], want)
    assert codes > 0
    jl_, jgrads, jmaster, jgnorm = ref[(POD_MESH, INT8)]
    loss_b, grad_b, master_b = IDENTITY_BOUNDS
    assert abs(runs[0][0] - jl_) / abs(jl_) < loss_b, (runs[0][0], jl_)
    assert abs(runs[0][1] - jgnorm) / jgnorm < grad_b
    grads = _global(POD_MESH, [run[2] for run in runs], axes="pod")
    assert rel(_flat(grads), _flat(jgrads)) < grad_b
    master = _global(POD_MESH, [run[3] for run in runs], axes="pod")
    assert rel(_flat(master), _flat(jmaster)) < master_b


# --------------------------------------------------------------------------
# (g), (h): the port alone
# --------------------------------------------------------------------------

def _one_process(monkeypatch, spec, stages_build):
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.models.transformer as tt
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    for mod in (tl, ta, tt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    model = _model(1, 1, fsdp_axes=("data",))
    ctx = ParallelCtx(plan=from_spec(spec), fsdp_axes=("data",))
    batch = SyntheticLM(DataConfig(model.cfg.vocab_size, SEQ, BATCH)).batch(0)
    init = model.init(0, dtype=torch.float32)
    out = []
    for build in stages_build:
        params = tree_map(lambda a: a.clone(), init)
        step = build(model, ctx, adamw.OptConfig(**OPT))
        _, opt, m = step(params, adamw.init_opt_state(params), batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    _flat([w.numpy() for w in adamw.leaves(opt["master"])])))
    return out


def test_pipeline_at_one_stage_is_the_plain_step(monkeypatch):
    """(g) At pipe = 1 (no ``torch.distributed``) the pipeline step over 4
    microbatches equals ``build_train_step`` on the whole batch within
    float reassociation: loss 1e-6, grad norm and master weights 1e-5."""
    from repro_torch.train.train_step import build_train_step
    (lp, gp, mp), (lt, gt, mt) = _one_process(
        monkeypatch, "baseline", (_pipe_build(1), build_train_step))
    assert abs(lp - lt) / lt < 1e-6
    assert abs(gp - gt) / gt < 1e-5
    assert rel(mp, mt) < 1e-5


@pytest.mark.parametrize("spec", ["tp=taco,skip_first=1", "tp=taco,warmup=5",
                                  "tp=taco,pp=tahquant,skip_last=1"])
def test_pipeline_step_rejects_unsupported_knobs(spec):
    """(h) The twin of the JAX package's
    ``tests/test_registry.py::test_pipeline_step_rejects_unsupported_knobs``:
    per-layer overrides and warmup scheduling are refused."""
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.optim import adamw
    from repro_torch.train.pipeline_parallel import (
        PipeConfig, build_pipeline_train_step)
    model = _model(1, 1, fsdp_axes=("data",))
    ctx = ParallelCtx(plan=from_spec(spec), fsdp_axes=("data",))
    with pytest.raises(NotImplementedError):
        build_pipeline_train_step(model, ctx, adamw.OptConfig(),
                                  PipeConfig(stages=1, microbatches=2))


@pytest.mark.parametrize("builder", ["plain", "pipeline"])
def test_steps_refuse_a_ctx_over_other_fsdp_axes(builder):
    """The model's fsdp axes and the ctx's are set apart; a step built from
    a model cut over ``("data",)`` and a ctx over the pod mesh's
    ``("pod", "data")`` is refused, not run with a group dropped."""
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    model = _model(1, 1, fsdp_axes=("data",))
    ctx = ParallelCtx(plan=from_spec("baseline"))
    build = build_train_step if builder == "plain" else _pipe_build(1)
    with pytest.raises(ValueError, match="fsdp axes"):
        build(model, ctx, adamw.OptConfig())


if __name__ == "__main__":
    jax_reference(sys.argv[1])
