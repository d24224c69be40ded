"""Sequence parallelism over a ``seq`` axis — the compressed all-to-all,
Ulysses and ring attention, the ``sp=`` path, the seq mesh and the
launcher's ``--sp`` / ``--sp-mode`` — held against the JAX package.

In this process (the JAX package on its one CPU device):

  * accounting: ``CommPlan.wire_bytes_per_element(n)`` and
    ``a2a_wire_bytes`` (the bound and the achieved bytes of a sample)
    equal the JAX package's for every spec of
    ``tests/test_torch_registry.py``; ``sp=taco:chunks=4`` is accounted as
    ``sp=taco`` (the sp hops never ring);
  * twins of the unit tests of ``tests/test_sp.py``: the ctx's defaults,
    an unknown ``sp_mode`` refused, the ``comm/sp_bytes_per_elem`` key, the
    model's plumbing (the seq axis among every param's summed axes and
    among the loss's, the batch's sequence shard, encdec and patches
    refused);
  * the ring's pieces: ``_block_bias``, ``_block_partial`` and
    ``_merge_partial`` against the JAX functions on the same f32 inputs
    (1e-6), the fully masked block a merge no-op, and the fold over 1, 2
    and 4 blocks against a dense softmax (1e-5, the bound of the JAX
    package's ``test_ring_partial_merge_equals_dense_softmax``, whose red
    case is a block count that does not divide the sequence; see
    ``ROADMAP.md`` §3).

Across processes: one gloo world of four spawned ranks (as
``tests/test_torch_dp.py`` runs it) and one JAX subprocess with four
forced host devices at the same meshes, started together:

  * ``all_to_all_c`` over groups of 2 and 4 ranks, for (split, concat) =
    (2, 1), (1, 2) and (1, 1), forward and backward: the identity codec
    bit for bit against the JAX package's tiled ``lax.all_to_all`` (f32
    and bf16); ``taco``, ``taco:folded`` and ``taco+zle:slot=auto``: every
    rank's wire rows against the JAX codec's by the parity rule of
    ``kernels/ref.py`` (the inner TACO wire of the stack), and the hop's
    output against the JAX codec's hop on the same inputs within rtol
    1e-4 / atol 1e-5 (``tests/test_kernels.py``); a split dim the group
    does not divide raises ``ValueError``;
  * Ulysses and ring attention at sp = 2 and 4 (batch 2, sequence 16, 4
    heads of 8, bf16; causal, and a window of 6) against the JAX
    package's at the same mesh: the identity codec's Ulysses bit for bit
    (and bit for bit the port's monolithic core on the whole sequence),
    the ring within one bf16 ulp of the JAX ring; under ``taco`` within
    :data:`TACO_BOUND` of the JAX flavour (both quantize q, k, v and the
    output; a code on the other side of a rounding boundary moves its
    element by a code step).  The ring's pipelined and serial schedules
    are bit-identical;
  * one training step at mesh pod 1, data 2, seq 2, model 1 (smoke
    qwen2-0.5b, 2 layers, global batch 4 x seq 64, f32 as
    ``tests/test_torch_dp.py`` computes it) under the identity plan with
    each flavour, against the JAX package's step at the same mesh: loss,
    grads and updated master weights within ``tests/test_torch_dp.py``'s
    identity bounds, and both seq ranks hold the same grads and weights.
    Under ``sp=taco:folded`` every all-to-all and permute of the step, on
    every rank, against the JAX codec's hop on the same per-rank inputs
    within ``tests/test_torch_dist_ref.py``'s ``HOP_BOUND``;
  * the launcher: ``--mesh 1,4,1 --sp 2`` under each ``--sp-mode``, from
    the JAX launcher's initial weights, prints the JAX launcher's loss
    line; ``--sp`` not dividing the data axis, and ``--seq`` not divisible
    by ``--sp``, exit with the JAX launcher's messages;
  * a checkpoint at mesh pod 1, data 1, seq 2, model 1 (two such meshes
    in the world): restored, it equals the state it saved bit for bit on
    both seq ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import math
import os
import pathlib
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from test_torch_dist import rel, run_group
from test_torch_dist_ref import HOP_BOUND, _f32
from test_torch_dp import (IDENTITY_BOUNDS, OPT, _flat, _global,
                           _port_step, _tree)
from test_torch_lossless import _jax_spec
from test_torch_registry import SUPPORTED
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the all-to-all's per-rank input: dims 1 and 2 divide by 2 and 4
A2A_SHAPE = (2, 8, 4, 32)
ORDERS = ((2, 1), (1, 2), (1, 1))
LOSSY = ("taco", "taco:folded", "taco+zle:slot=auto")
#: the attention inputs: batch, sequence, heads, head dim
ATT = (2, 16, 4, 8)
WINDOW = 6
#: the taco flavours against the JAX package's, relative
TACO_BOUND = HOP_BOUND
SEQ, BATCH = 64, 4
STEP_MESH = (1, 2, 2, 1)
MODES = ("ulysses", "ring")
LAUNCH = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "2", "--seq", "32",
          "--batch", "4", "--mesh", "1,4,1", "--sp", "2",
          "--comm-spec", "baseline"]
#: the launchers' printed losses, absolute (bf16 in both packages)
LAUNCH_BOUND = 1e-3
JAX_TIMEOUT_S = 400


def _jcodec(spec):
    """The JAX package's codec of a port codec spec (TACO's oracle)."""
    from repro.core.registry import codec_from_spec
    return codec_from_spec(_jax_spec(spec))


def _a2a_inputs(p):
    gen = np.random.default_rng(2300 + p)
    return [tp_like(gen, A2A_SHAPE) for _ in range(4)], \
        [tp_like(gen, A2A_SHAPE) for _ in range(4)]


def _out_shape(shape, p, split, concat):
    out = list(shape)
    out[split] //= p
    out[concat] *= p
    return tuple(out)


def _att_inputs():
    """q, k, v exactly representable in bf16, so that both packages cast
    them to the same bits."""
    gen = np.random.default_rng(2311)
    return [torch.from_numpy(gen.normal(size=ATT).astype(np.float32))
            .bfloat16().float().numpy() for _ in range(3)]


def _att_cases():
    for p in (2, 4):
        for mode in MODES:
            for spec in ("none", "taco"):
                yield p, mode, spec, None
            yield p, mode, "none", WINDOW


# --------------------------------------------------------------------------
# the JAX package, four forced host devices
# --------------------------------------------------------------------------

def jax_reference(out: str, ckpt: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.launch.train as jlaunch
    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    from repro.compat import shard_map
    from repro.configs import get_config, make_plan, smoke_config
    from repro.core import collectives as jcc
    from repro.core.collectives import psum_exact
    from repro.core.parallel import CommPlan, ParallelCtx
    from repro.core.registry import codec_from_spec, from_spec
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.train.train_step import dp_axes
    assert len(jax.devices()) == 4
    res = {}
    ident = codec_from_spec("none")
    # all_to_all_c, identity codec: forward and backward
    for p in (2, 4):
        mesh = jax.make_mesh((4 // p, p), ("data", "seq"))
        xs, cts = _a2a_inputs(p)
        for dtype in (jnp.float32, jnp.bfloat16):
            x = jnp.asarray(np.stack(xs).reshape(4 // p, p, *A2A_SHAPE),
                            dtype)
            ct = np.stack(cts).reshape(4 // p, p, *A2A_SHAPE)
            for split, concat in ORDERS:
                def f(a, c, split=split, concat=concat):
                    y, vjp = jax.vjp(lambda v: jcc.all_to_all_c(
                        v, "seq", split + 2, concat + 2, ident, ident), a)
                    oshape = y.shape
                    (g,) = vjp(c.reshape(oshape))
                    return y, g
                oshape = _out_shape(A2A_SHAPE, p, split, concat)
                ctj = jnp.asarray(np.stack([
                    c.reshape(-1)[:math.prod(oshape)].reshape(oshape)
                    for c in cts]).reshape(4 // p, p, *oshape), dtype)
                spec = P("data", "seq")
                y, g = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                         out_specs=(spec, spec),
                                         check_vma=False))(x, ctj)
                res[("a2a", p, str(dtype.dtype), split, concat)] = (
                    np.asarray(y, np.float32).reshape(4, *oshape),
                    np.asarray(g, np.float32).reshape(4, *A2A_SHAPE))
    # the attention flavours at sp = p
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _att_inputs())
    for p, mode, spec, window in _att_cases():
        mesh = jax.make_mesh((4 // p, p), ("data", "seq"))
        codec = codec_from_spec(_jax_spec(spec)) if spec != "none" else ident
        ctx = ParallelCtx(plan=CommPlan(sp=codec), sp_axis="seq",
                          sp_mode=mode)
        sspec = P(None, "seq")
        f = jax.jit(shard_map(
            lambda a, b, c, ctx=ctx, window=window: ja.sp_attention(
                a, b, c, ctx, causal=True, window=window),
            mesh=mesh, in_specs=(sspec,) * 3, out_specs=sspec,
            check_vma=False))
        res[("att", p, mode, spec, window)] = np.asarray(f(q, k, v),
                                                         np.float32)
    # one training step at the seq mesh, identity plan, f32
    for mod in (jl, ja, jt):
        mod.COMPUTE_DTYPE = jnp.float32
    cfg = smoke_config(get_config("qwen2-0.5b"))
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    oc = adamw.OptConfig(**OPT)
    res["batch"] = {k_: np.asarray(v_) for k_, v_ in batch.items()}
    model = Model(cfg, make_plan(cfg, 1, 2), sp_axis="seq")
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    mesh = jax.make_mesh(STEP_MESH, ("pod", "data", "seq", "model"))
    pspecs, bspecs = model.partition_specs(), model.batch_pspecs()
    ospecs = adamw.opt_state_pspecs(pspecs)

    def put(tree, specs):
        return jax.tree.map(lambda x_, s: jax.device_put(
            x_, NamedSharding(mesh, s)), tree, specs)
    args = (put(params, pspecs), put(adamw.init_opt_state(params), ospecs),
            {k_: jax.device_put(v_, NamedSharding(mesh, bspecs[k_]))
             for k_, v_ in batch.items()})
    for mode in MODES:
        ctx = ParallelCtx(plan=from_spec("baseline"), sp_axis="seq",
                          sp_mode=mode)

        def step(q_, o, b, ctx=ctx):
            def loss_fn(qq):
                loss_sum, count, _ = model.loss_parts(qq, b, ctx)
                loss_sum = psum_exact(loss_sum, dp_axes(model))
                count = jax.lax.psum(jax.lax.stop_gradient(count),
                                     dp_axes(model))
                return loss_sum / jnp.maximum(count, 1.0)
            loss, grads = jax.value_and_grad(loss_fn)(q_)
            grads = adamw.finalize_grads(grads, model)
            _, new, m = adamw.adamw_update(grads, o, oc, model)
            return loss, grads, new["master"], m["grad_norm"]
        f = jax.jit(shard_map(step, mesh=mesh,
                              in_specs=(pspecs, ospecs, bspecs),
                              out_specs=(P(), pspecs, pspecs, P()),
                              check_vma=False))
        loss, grads, master, gnorm = f(*args)
        leaves = jax.tree_util.tree_leaves
        res[("step", mode)] = (
            float(loss), [np.asarray(g, np.float32) for g in leaves(grads)],
            [np.asarray(w, np.float32) for w in leaves(master)],
            float(gnorm))
    for mod in (jl, ja, jt):
        mod.COMPUTE_DTYPE = jnp.bfloat16
    # the launcher: its loss line under each flavour, and its refusals
    for mode in MODES:
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = ["train", *LAUNCH, "--sp-mode", mode, "--ckpt",
                    f"{ckpt}-{mode}"]
        try:
            with contextlib.redirect_stdout(buf):
                jlaunch.main()
        finally:
            sys.argv = argv
        res[("launch", mode)] = buf.getvalue().strip().splitlines()[-1]
    for extra in (["--sp", "3"], ["--seq", "33"]):
        sys.argv = ["train", *LAUNCH, *extra, "--ckpt", f"{ckpt}-x"]
        try:
            jlaunch.main()
        except SystemExit as e:
            res[("refuse", tuple(extra))] = str(e)
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


# --------------------------------------------------------------------------
# the port, on every rank of a gloo world of four
# --------------------------------------------------------------------------

def _groups(p):
    """This rank's group of ``p`` consecutive ranks (every rank creates
    every group, in the same order)."""
    import torch.distributed as dist
    me = dist.get_rank()
    out = None
    for base in range(0, 4, p):
        g = dist.new_group(list(range(base, base + p)))
        if base <= me < base + p:
            out = g
    return out


def _sub_mesh(shape):
    """This rank's mesh of ``shape`` on the seq mesh's axes, the world cut
    into meshes of consecutive ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import SP_AXES, Mesh, axis_ranks
    me, size = dist.get_rank(), math.prod(shape)
    groups = {}
    for base in range(0, 4, size):
        for axis in reversed(SP_AXES):
            for ranks in axis_ranks(shape, axis, SP_AXES):
                g = dist.new_group([base + r for r in ranks])
                if me - base in ranks:
                    groups[axis] = g
    return Mesh(shape, me % size, groups, SP_AXES)


@contextlib.contextmanager
def _recording(hops):
    """Within the block, each compressed all-to-all and permute of the
    port appends ``(kind, args, input, output)`` to ``hops``."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.codecs import IdentityCodec
    saved = cc._a2a_impl, cc._pp_impl

    def a2a(x, group, split, concat, codec):
        out = saved[0](x, group, split, concat, codec)
        if not isinstance(codec, IdentityCodec):
            hops.append(("a2a", (split, concat), x.detach().numpy().copy(),
                         out.detach().numpy().copy()))
        return out

    def pp(x, group, perm, codec):
        out = saved[1](x, group, perm, codec)
        if not isinstance(codec, IdentityCodec):
            hops.append(("pp", perm, x.detach().numpy().copy(),
                         out.detach().numpy().copy()))
        return out
    cc._a2a_impl, cc._pp_impl = a2a, pp
    try:
        yield
    finally:
        cc._a2a_impl, cc._pp_impl = saved


def _sp_task(rank, p_world, group, pl):
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import collectives as cc
    from repro_torch.core.parallel import CommPlan, ParallelCtx
    from repro_torch.core.registry import codec_from_spec, from_spec
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import attention as ta
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    res = {}
    groups = {p: _groups(p) for p in (2, 4)}
    # all_to_all_c
    for p in (2, 4):
        g = groups[p]
        xs, cts = _a2a_inputs(p)
        for spec in ("none", *LOSSY):
            c = codec_from_spec(spec)
            for dtype in ((torch.float32, torch.bfloat16) if spec == "none"
                          else (torch.float32,)):
                for split, concat in ORDERS:
                    x = torch.from_numpy(xs[rank]).to(dtype)
                    x.requires_grad_(True)
                    y = cc.all_to_all_c(x, g, split, concat, c, c)
                    ct = torch.from_numpy(cts[rank].reshape(-1)[
                        :y.numel()].reshape(y.shape)).to(dtype)
                    y.backward(ct)
                    res[("a2a", p, spec, str(dtype), split, concat)] = (
                        y.detach().float().numpy(), x.grad.float().numpy())
        try:
            cc.all_to_all_c(torch.zeros(2, 3, 4), g, 1, 2,
                            codec_from_spec("taco"), cc.Identity)
            res[("a2a refuses", p)] = None
        except ValueError as e:
            res[("a2a refuses", p)] = str(e)
    # the attention flavours
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _att_inputs())
    for p, mode, spec, window in _att_cases():
        i = rank % p
        s = ATT[1] // p
        shard = [a[:, i * s:(i + 1) * s] for a in (q, k, v)]
        scheds = ("", ":schedule=serial") if mode == "ring" and \
            spec != "none" else ("",)
        for sched in scheds:
            codec = codec_from_spec(spec + sched)
            ctx = ParallelCtx(plan=CommPlan(sp=codec), sp_group=groups[p],
                              sp_mode=mode)
            with torch.no_grad():
                out = ta.sp_attention(*shard, ctx, causal=True,
                                      window=window)
            res[("att", p, mode, spec + sched, window)] = out.float().numpy()
    # one training step at the seq mesh
    ta_f32 = ta.COMPUTE_DTYPE
    _f32()
    glob = {k_: torch.from_numpy(v_) for k_, v_ in pl["batch"].items()}
    mesh = init_mesh(STEP_MESH, "cpu", axes=pl["axes"])
    cfg = configs.smoke_config(configs.get_config("qwen2-0.5b"))
    model = Model(cfg, configs.make_plan(cfg, 1, 2), device="cpu",
                  **mesh.model_kwargs())
    batch = model.batch_slice(glob)
    res["coords"] = mesh.coords
    for mode in MODES:
        res[("step", mode)] = _port_step(
            model, mesh.parallel_ctx(from_spec("baseline"), mode),
            pl["tree"], batch)
        hops = []
        with _recording(hops):
            res[("taco step", mode)] = _port_step(
                model, mesh.parallel_ctx(from_spec("sp=taco:folded"), mode),
                pl["tree"], batch)
        res[("taco hops", mode)] = hops
    for mod in (ta, sys.modules["repro_torch.models.layers"],
                sys.modules["repro_torch.models.transformer"]):
        mod.COMPUTE_DTYPE = ta_f32
    # the launcher, from the JAX launcher's initial weights
    for mode in MODES:
        args = train.parse_args([*LAUNCH, "--sp-mode", mode, "--device",
                                 "cpu"])
        trainer, _ = train.build_trainer(args)
        params = trainer.model.from_jax_params(pl["launch_tree"])
        _, _, hist = trainer.run(params=params)
        res[("launch", mode)] = [h["loss"] for h in hist]
        res[("launch ctx", mode)] = (trainer.ctx.sp_size(),
                                     trainer.ctx.sp_index(),
                                     trainer.ctx.sp_mode,
                                     trainer.model.sp_rank)
    # a checkpoint round trip at mesh 1, 1, 2, 1
    sub = _sub_mesh((1, 1, 2, 1))
    ctx = sub.parallel_ctx(from_spec("sp=taco:folded"), "ring")
    m2 = Model(cfg, configs.make_plan(cfg, 1, 1), device="cpu",
               **sub.model_kwargs())
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2), cfg)
    tr = Trainer(m2, ctx, adamw.OptConfig(**OPT),
                 TrainerConfig(total_steps=2, ckpt_every=2,
                               ckpt_dir=pl["ckpt"]), data)
    params, opt, hist = tr.run(resume=False)
    restored = tr.try_restore(params, opt)
    assert restored is not None
    rp, ro, step = restored
    saved = adamw.leaves(params) + adamw.leaves(
        {k_: opt[k_] for k_ in ("master", "mu", "nu")})
    back = adamw.leaves(rp) + adamw.leaves(
        {k_: ro[k_] for k_ in ("master", "mu", "nu")})
    res["ckpt"] = (step, ro["step"], opt["step"],
                   all(torch.equal(a, b) for a, b in zip(saved, back)),
                   [h["loss"] for h in hist],
                   [a.float().numpy() for a in back[:3]])
    dist.barrier()
    return res


# --------------------------------------------------------------------------
# the fixture: both packages at once
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with subprocess.Popen([sys.executable, __file__, str(tmp / "jax.pkl"),
                           str(tmp / "jax-ckpt")],
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        try:
            from repro.configs import get_config, make_plan, smoke_config
            from repro.data.pipeline import DataConfig, SyntheticLM
            from repro.models.model import Model as JModel
            from repro_torch.launch.mesh import SP_AXES
            cfg = smoke_config(get_config("qwen2-0.5b"))
            batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH),
                                cfg).batch(0)
            nb = {k: np.asarray(v).astype(np.float32 if k == "mask"
                                          else np.int64)
                  for k, v in batch.items()}
            launch_tree = jax.device_get(JModel(cfg, make_plan(
                cfg, 1, 2)).init(jax.random.PRNGKey(0)))
            port = run_group(tmp, 4, _sp_task,
                             {"tree": _tree(1), "batch": nb,
                              "axes": SP_AXES, "launch_tree": launch_tree,
                              "ckpt": str(tmp / "port-ckpt")})
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
# all_to_all_c
# --------------------------------------------------------------------------

def _jax_a2a(xs, codec, split, concat):
    """Every rank's compressed all-to-all of the per-rank inputs ``xs``
    (one group) through the JAX codec: each rank's rows encoded, row j of
    rank i decoded on rank j, the blocks joined peer-major."""
    p = len(xs)
    moved = [np.moveaxis(x, split, 0) for x in xs]
    d = moved[0].shape[0]
    rows = [np.reshape(m, (p, -1)) for m in moved]
    n = rows[0].shape[-1]
    pad = (-n) % codec.granule
    wires = [np.asarray(codec.encode_wire(jnp.asarray(
        np.pad(r, ((0, 0), (0, pad)))))) for r in rows]
    outs = []
    for j in range(p):
        stack = jnp.asarray(np.stack([w[j] for w in wires]))
        dec = np.asarray(codec.decode_wire(stack, n + pad, jnp.float32))
        st = dec[:, :n].reshape(p, d // p, *moved[0].shape[1:])
        blocks = np.moveaxis(st, 1, split + 1)
        out = np.moveaxis(blocks, 0, concat)
        outs.append(out.reshape(_out_shape(xs[0].shape, p, split, concat)))
    return outs


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("order", ORDERS, ids=["2to1", "1to2", "1to1"])
def test_identity_all_to_all_is_jaxs_tiled_layout(both, p, dtype, order):
    """The identity codec's forward and backward, bit for bit the JAX
    package's tiled ``lax.all_to_all`` on ``p`` devices."""
    ref, port = both
    jdt = "float32" if dtype == "torch.float32" else "bfloat16"
    y_ref, g_ref = ref[("a2a", p, jdt) + order]
    for r in range(4):
        y, g = port[r][("a2a", p, "none", dtype) + order]
        np.testing.assert_array_equal(y, y_ref[r])
        np.testing.assert_array_equal(g, g_ref[r])


def _hold_wires(spec, xs, split):
    """Every rank's wire rows of the hop against the JAX codec's by the
    parity rule (a stack: its inner TACO wire)."""
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ref as kref
    c, jc = codec_from_spec(spec), _jcodec(spec)
    c, jc = getattr(c, "inner", c), getattr(jc, "inner", jc)
    p = len(xs)
    for x in xs:
        rows = np.moveaxis(x, split, 0).reshape(p, -1)
        pad = (-rows.shape[-1]) % c.granule
        rows = np.pad(rows, ((0, 0), (0, pad)))
        kref.check_wire_parity(
            c.encode_wire(torch.from_numpy(rows)),
            torch.from_numpy(np.array(jc.encode_wire(jnp.asarray(rows)))),
            rows.shape[-1], c.cfg)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("spec", LOSSY)
@pytest.mark.parametrize("order", ORDERS, ids=["2to1", "1to2", "1to1"])
def test_lossy_all_to_all_matches_the_jax_codec(both, p, spec, order):
    """Wires by the parity rule, and the forward hop and the backward hop
    (the dims swapped) against the JAX codec's on the same inputs."""
    _, port = both
    split, concat = order
    xs, cts = _a2a_inputs(p)
    jc = _jcodec(spec)
    for base in range(0, 4, p):
        grp = range(base, base + p)
        _hold_wires(spec, [xs[r] for r in grp], split)
        want = _jax_a2a([xs[r] for r in grp], jc, split, concat)
        oshape = want[0].shape
        cs = [cts[r].reshape(-1)[:math.prod(oshape)].reshape(oshape)
              for r in grp]
        want_g = _jax_a2a(cs, jc, concat, split)
        for i, r in enumerate(grp):
            y, g = port[r][("a2a", p, spec, "torch.float32", split, concat)]
            np.testing.assert_allclose(y, want[i], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, want_g[i], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("p", [2, 4])
def test_all_to_all_refuses_a_split_dim_the_group_does_not_divide(both, p):
    _, port = both
    for r in range(4):
        msg = port[r][("a2a refuses", p)]
        assert msg is not None and "not divisible" in msg, msg


# --------------------------------------------------------------------------
# the attention flavours
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(_att_cases()),
                         ids=lambda c: f"sp{c[0]}-{c[1]}-{c[2]}-w{c[3]}")
def test_flavours_match_jax_at_the_same_mesh(both, case):
    ref, port = both
    p, mode, spec, window = case
    want = ref[("att", *case)]
    s = ATT[1] // p
    for r in range(4):
        i = r % p
        got = port[r][("att", *case)]
        w = want[:, i * s:(i + 1) * s]
        if spec != "none":
            assert rel(got, w) < TACO_BOUND, (r, rel(got, w))
        elif mode == "ulysses":
            np.testing.assert_array_equal(got, w)
        else:
            # one bf16 ulp: 2^-8 of the larger magnitude's binade
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                np.abs(w), 1e-30))) - 7)
            assert np.all(np.abs(got - w) <= ulp), float(
                np.max(np.abs(got - w) / ulp))


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("window", [None, WINDOW])
def test_ulysses_identity_is_the_monolithic_core(both, p, window):
    """Ulysses under the identity codec runs the port's monolithic core on
    the whole sequence: bit for bit that core's output, cut to the rank's
    shard."""
    _, port = both
    from repro_torch.models import attention as ta
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _att_inputs())
    full = ta.attention_core(q, k, v, causal=True, window=window).float()
    s = ATT[1] // p
    for r in range(4):
        i = r % p
        np.testing.assert_array_equal(
            port[r][("att", p, "ulysses", "none", window)],
            full[:, i * s:(i + 1) * s].numpy())


@pytest.mark.parametrize("p", [2, 4])
def test_ring_schedules_are_bit_identical(both, p):
    _, port = both
    for r in range(4):
        np.testing.assert_array_equal(
            port[r][("att", p, "ring", "taco", None)],
            port[r][("att", p, "ring", "taco:schedule=serial", None)])


# --------------------------------------------------------------------------
# the step at mesh 1, 2, 2, 1
# --------------------------------------------------------------------------

def _seq_zero(port, key):
    """The runs of the ranks at seq index 0, by data index, and a check
    that the other seq rank holds the same grads and weights."""
    from repro_torch.launch.mesh import mesh_rank
    runs = []
    for d in range(STEP_MESH[1]):
        a = port[mesh_rank((0, d, 0, 0), STEP_MESH)][key]
        b = port[mesh_rank((0, d, 1, 0), STEP_MESH)][key]
        assert a[0] == b[0]
        for x, y in zip(a[2] + a[3], b[2] + b[3]):
            np.testing.assert_array_equal(x, y)
        runs.append(a)
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_identity_step_matches_jax_at_the_same_mesh(both, mode):
    ref, port = both
    from repro_torch.launch.mesh import mesh_coords
    for r in range(4):
        assert port[r]["coords"] == mesh_coords(r, STEP_MESH)
    loss_b, grad_b, master_b = IDENTITY_BOUNDS
    jl_, jgrads, jmaster, jgnorm = ref[("step", mode)]
    runs = _seq_zero(port, ("step", mode))
    loss, gnorm = runs[0][:2]
    assert abs(loss - jl_) / abs(jl_) < loss_b, (loss, jl_)
    assert abs(gnorm - jgnorm) / jgnorm < grad_b
    shape = (STEP_MESH[0], STEP_MESH[1], STEP_MESH[3])
    grads = _global(shape, [r[2] for r in runs])
    assert rel(_flat(grads), _flat(jgrads)) < grad_b
    master = _global(shape, [r[3] for r in runs])
    assert rel(_flat(master), _flat(jmaster)) < master_b


@pytest.mark.parametrize("mode", MODES)
def test_taco_step_hops_match_the_jax_codec(both, mode):
    """Under ``sp=taco:folded``: the step's sp hops (Ulysses: 2 all-to-alls
    a layer forward, 2 backward, 2 recomputed; ring: 1 permute a layer
    each way and recomputed), every one on every rank against the JAX
    codec on the same per-rank inputs."""
    _, port = both
    from repro_torch.launch.mesh import SP_AXES, axis_ranks
    jc = _jcodec("taco:folded")
    hops = [port[r][("taco hops", mode)] for r in range(4)]
    layers = 2
    assert len({len(h) for h in hops}) == 1
    assert len(hops[0]) == layers * (2 if mode == "ulysses" else 1) * 3
    for ranks in axis_ranks(STEP_MESH, "seq", SP_AXES):
        for k, (kind, how, _, _) in enumerate(hops[ranks[0]]):
            assert all(hops[r][k][:2] == (kind, how) for r in ranks)
            xs = [hops[r][k][2] for r in ranks]
            if kind == "a2a":
                want = _jax_a2a(xs, jc, *how)
            else:
                srcs = {d: s for s, d in how}
                want = []
                for i in range(len(ranks)):
                    x = xs[srcs[i]].reshape(1, -1)
                    pad = (-x.shape[-1]) % jc.granule
                    xp = jnp.asarray(np.pad(x, ((0, 0), (0, pad))))
                    dec = np.asarray(jc.decode_wire(jc.encode_wire(xp),
                                                    x.shape[-1] + pad,
                                                    jnp.float32))
                    want.append(dec[:, :x.shape[-1]].reshape(xs[0].shape))
            for i, r in enumerate(ranks):
                err = rel(hops[r][k][3], want[i])
                assert err < HOP_BOUND, (mode, k, kind, r, err)
    runs = _seq_zero(port, ("taco step", mode))
    assert np.isfinite(runs[0][0])


# --------------------------------------------------------------------------
# the launcher and the checkpoint
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_launcher_prints_the_jax_launchers_loss_line(both, mode):
    """The JAX launcher's summary line, its losses within
    :data:`LAUNCH_BOUND`: both launchers compute in bf16, whose matmuls
    the two packages round apart (the f32 step above agrees to 1e-6)."""
    ref, port = both
    line = ref[("launch", mode)]
    m = re.fullmatch(r"qwen2-0\.5b-smoke: loss (\S+) -> (\S+) \(2 steps, "
                     r"comm_spec=baseline\)", line)
    assert m, line
    for r in range(4):
        losses = port[r][("launch", mode)]
        assert port[r][("launch ctx", mode)] == (2, r % 2, mode, r % 2)
        assert len(losses) == 2 and losses == port[0][("launch", mode)]
        for got, want in zip((losses[0], losses[-1]), m.groups()):
            assert abs(got - float(want)) < LAUNCH_BOUND, (losses, line)


@pytest.mark.parametrize("extra", [["--sp", "3"], ["--seq", "33"]])
def test_launcher_refusals_are_the_jax_launchers(both, extra):
    ref, _ = both
    from repro_torch.launch import train
    args = train.parse_args([*LAUNCH, *extra, "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        train.build_trainer(args)
    assert str(exc.value) == ref[("refuse", tuple(extra))]


def test_checkpoint_round_trip_at_seq_2(both):
    """Mesh 1, 1, 2, 1: the state restored equals the state saved bit for
    bit on both seq ranks, and both ranks hold the same state."""
    _, port = both
    runs = [port[r]["ckpt"] for r in range(4)]
    for step, rstep, ostep, same, losses, _ in runs:
        assert (step, rstep, ostep, same) == (2, 2, 2, True)
        assert losses == runs[0][4] and np.all(np.isfinite(losses))
    for r in range(1, 4):
        for a, b in zip(runs[r][5], runs[0][5]):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# in this process: accounting, plumbing, the ring's pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SUPPORTED + ["sp=taco:chunks=4",
                                              "sp=taco+zle:slot=auto"])
def test_wire_bytes_per_element_with_n_matches_jax(spec):
    from repro.core import registry as jreg
    from repro_torch.core import registry as reg
    plan, jplan = reg.from_spec(spec), jreg.from_spec(spec)
    for n in (None, 256, 1000, 3584, 5_505_024):
        assert plan.wire_bytes_per_element(n) == \
            jplan.wire_bytes_per_element(n), (spec, n)


def test_sp_wire_accounting_is_monolithic():
    from repro_torch.core import registry as reg
    chunked = reg.from_spec("sp=taco:chunks=4")
    for n in (None, 1000, 4096):
        assert chunked.wire_bytes_per_element(n)["sp"] == \
            reg.from_spec("sp=taco").wire_bytes_per_element(n)["sp"]


@pytest.mark.parametrize("spec", ["none", "taco", "taco:folded",
                                  "taco:chunks=4", "taco+zle:slot=auto",
                                  "sdp4bit", "int8"])
@pytest.mark.parametrize("p", [2, 4])
def test_a2a_wire_bytes_match_jax(spec, p):
    from repro.core import collectives as jcc
    from repro_torch.core import collectives as cc
    from repro_torch.core.registry import codec_from_spec
    c, jc = codec_from_spec(spec), _jcodec(spec)
    x = tp_like(np.random.default_rng(7), (4, 16, 4, 12))
    x[:, :8] = 0.0
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        assert cc.a2a_wire_bytes(x.shape, dtype, p, c) == \
            jcc.a2a_wire_bytes(x.shape, jdt, p, jc)
    assert cc.a2a_wire_bytes(x.shape, torch.float32, p, c,
                             sample=torch.from_numpy(x)) == \
        pytest.approx(jcc.a2a_wire_bytes(x.shape, jnp.float32, p, jc,
                                         sample=jnp.asarray(x)), rel=1e-12)


def test_parallel_ctx_sp_defaults():
    from repro_torch.core import parallel as par
    from repro_torch.core.registry import from_spec
    ctx = par.ParallelCtx(plan=from_spec("baseline"))
    assert not ctx.sp_active
    assert (ctx.sp_size(), ctx.sp_index(), ctx.sp_mode) == (1, 0, "ulysses")
    assert ctx.axis_group("seq") is None
    plan = from_spec("sp=taco:folded")
    assert plan.sp.cfg.metadata == "folded"
    assert par.SP_AXIS == "seq" and "sp" in par.PATHS


def test_sp_mode_dispatch_rejects_unknown():
    from repro_torch.core import parallel as par
    from repro_torch.core.registry import from_spec
    from repro_torch.models import attention as ta
    ctx = par.ParallelCtx(plan=from_spec("baseline"), sp_group=1,
                          sp_mode="bogus")
    x = torch.zeros((1, 2, 2, 2))
    with pytest.raises(ValueError, match="unknown sp_mode"):
        ta.sp_attention(x, x, x, ctx, causal=True, window=None)


def test_sp_telemetry_key_flows():
    from repro_torch.core import telemetry
    from repro_torch.core.registry import from_spec
    metrics = telemetry.comm_metrics(from_spec("sp=taco"))
    assert "comm/sp_bytes_per_elem" in metrics


def test_model_sp_axis_plumbing():
    """The seq axis among every param's summed axes and the loss's; the
    batch's sequence shard after the fsdp rows; encdec and patches
    refused; a 1-rank seq group runs the plain core (no hop)."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import dp_axes
    cfg = dataclasses.replace(configs.smoke_config(
        configs.get_config("gpt-350m")), n_layers=2)
    model = Model(cfg, configs.make_plan(cfg, 1, 2), device="cpu",
                  fsdp_axes=("data",), fsdp_rank=1, sp_axis="seq", sp=2,
                  sp_rank=1)
    assert all("seq" in model.replicated_grad_axes(s)
               for s in adamw.leaves(model.specs()))
    assert dp_axes(model) == ("data", "seq")
    assert dp_axes(Model(cfg, configs.make_plan(cfg, 1, 1), device="cpu",
                         fsdp_axes=("data",))) == ("data",)
    glob = {"tokens": torch.arange(32).reshape(4, 8)}
    np.testing.assert_array_equal(model.batch_slice(glob)["tokens"],
                                  glob["tokens"][2:4, 4:8])
    for fam in (dict(family="encdec"), dict(frontend="patches")):
        with pytest.raises(NotImplementedError, match="sequence parallel"):
            Model(dataclasses.replace(cfg, **fam), configs.make_plan(cfg, 1, 1),
                  device="cpu", sp_axis="seq", sp=1)


def test_cross_attention_refused_under_sp():
    from repro_torch import configs
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.models import attention as ta
    cfg = configs.smoke_config(configs.get_config("qwen2-0.5b"))
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="under an active sp"):
        ta.attention_apply(x, {}, cfg, configs.make_plan(cfg, 1, 1),
                           ParallelCtx(sp_group=1), kv_source=x)


def _qkv(seed, shape=(2, 2, 16, 8)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 5])
def test_ring_pieces_match_jax(causal, window):
    """Within 1e-6 on q pre-scaled as the ring scales it (1/sqrt(hd)): the
    two packages' f32 scores are a few ulps apart (their dot products
    add in other orders), and so are the exponentials."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    qf, kb, vb = _qkv(3)
    qf = qf / np.float32(np.sqrt(8))
    q_pos, kv_pos = np.arange(16) + 16, np.arange(16) + 8
    bias = ta._block_bias(torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                          causal=causal, window=window)
    jbias = ja._block_bias(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                           causal=causal, window=window)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    part = ta._block_partial(*(torch.from_numpy(a) for a in (qf, kb, vb)),
                             bias)
    jpart = ja._block_partial(*(jnp.asarray(a) for a in (qf, kb, vb)), jbias)
    for a, b in zip(part, jpart):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    q4, k4, v4 = _qkv(4)
    q4 = q4 / np.float32(np.sqrt(8))
    other = ta._block_partial(*(torch.from_numpy(a) for a in (q4, k4, v4)),
                              torch.zeros(16, 16))
    jother = ja._block_partial(*(jnp.asarray(a) for a in (q4, k4, v4)),
                               jnp.zeros((16, 16)))
    merged = ta._merge_partial(part, other)
    jmerged = ja._merge_partial(jpart, jother)
    for a, b in zip(merged, jmerged):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_fully_masked_block_partial_is_a_merge_noop():
    from repro_torch.models import attention as ta
    qf, kb, vb = (torch.from_numpy(a) for a in _qkv(0, (1, 1, 4, 8)))
    bias = ta._block_bias(torch.arange(4), torch.arange(4) + 100,
                          causal=True, window=None)
    acc, m, l = empty = ta._block_partial(qf, kb, vb, bias)
    assert torch.all(acc == 0) and torch.all(l == 0)
    assert torch.all(m == ta.NEG_INF)
    live = ta._block_partial(qf, kb, vb, ta._block_bias(
        torch.arange(4), torch.arange(4), causal=True, window=None))
    for merged in (ta._merge_partial(live, empty),
                   ta._merge_partial(empty, live)):
        for a, b in zip(merged, live):
            assert torch.equal(a, b)


@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 8])
def test_ring_fold_equals_dense_softmax(blocks, causal, window):
    """KV cut into ``blocks`` blocks (each a divisor of the sequence), one
    partial a block, folded in order: the dense softmax within 1e-5."""
    from repro_torch.models import attention as ta
    q, k, v = (torch.from_numpy(a) for a in _qkv(11 + blocks,
                                                  (2, 2, 16, 8)))
    qf = q / np.sqrt(8)
    pos = torch.arange(16)
    w = 16 // blocks
    state = None
    for j in range(blocks):
        sl = slice(j * w, (j + 1) * w)
        part = ta._block_partial(qf, k[:, :, sl], v[:, :, sl], ta._block_bias(
            pos, pos[sl], causal=causal, window=window))
        state = part if state is None else ta._merge_partial(state, part)
    acc, _, l = state
    out = acc / l.clamp_min(1e-30)[..., None]
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, k) + ta._block_bias(
        pos, pos, causal=causal, window=window)
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)
    assert float((out - ref).abs().max()) < 1e-5


def test_hops_per_step_count_the_sp_hops():
    """``tp_hops_per_step``'s sp kinds: Ulysses' two all-to-alls a layer,
    the ring's sp - 1 permutes, each run forward, backward and
    recomputed; none at sp = 1 or under the identity sp codec."""
    from repro_torch import configs
    from repro_torch.core.registry import from_spec
    from repro_torch.models import transformer
    cfg = configs.smoke_config(configs.get_config("qwen2-0.5b"))
    for remat in (True, False):
        plan = configs.make_plan(cfg, 1, 1, remat=remat)
        comm = from_spec("sp=taco:folded")
        times = cfg.n_layers * (3 if remat else 2)
        assert transformer.tp_hops_per_step(cfg, plan, comm, 4, "ulysses")[
            "all_to_all"] == 2 * times
        assert transformer.tp_hops_per_step(cfg, plan, comm, 4, "ring")[
            "permute"] == 3 * times
        for sp, c in ((1, comm), (4, from_spec("baseline"))):
            h = transformer.tp_hops_per_step(cfg, plan, c, sp, "ring")
            assert (h["all_to_all"], h["permute"]) == (0, 0)


if __name__ == "__main__":
    jax_reference(sys.argv[1], sys.argv[2])
