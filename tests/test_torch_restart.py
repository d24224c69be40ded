"""Restart, elastic restore and the summed replicated grads over a mesh of
processes, held against the JAX package.

A gloo world of four spawned processes (as ``tests/test_torch_dp.py``
runs it) and, for the summed grads, the JAX package in a subprocess with
four forced host devices, started together.

  * Summed replicated grads (fault F4).  The same seeded bf16 per-rank
    grads of every parameter (each rank's shard shapes; magnitudes spread
    over ~e^±4 so that sums round) go through the JAX package's
    ``finalize_grads`` in a ``shard_map`` at mesh (1, 2, 2) and its
    ``_finalize_pipe_grads`` at pipe mesh (2, 1, 2), and through the
    port's ``finalize_grads`` (with the pipe group on the pipe mesh, as
    its pipeline step calls it) on the gloo ranks at the same meshes.  The JAX package
    sums each leaf with one ``psum`` over its tuple of axes, in f32, and
    rounds once to bf16 (measured here: bit for bit the f32 sum rounded
    once; a bf16 add per peer differs in a quarter of the elements).  The
    port's summed leaves must equal the reference's bit for bit, in bf16.
    The parent's port kept the unrounded f32 sums: the test counts how
    many summed elements that changes.
  * Restart after an injected failure at mesh (1, 2, 2) under
    ``tp=taco,grad_rs=sdp4bit`` (smoke qwen2-0.5b, bf16, global batch 4 x
    seq 32): 6 steps with a checkpoint every 3, uninterrupted, and again
    with a failure injected at step 4 (the trainer restores step 3 and
    replays): every rank's final parameters and optimizer state bit for
    bit the uninterrupted run's, and the two step-6 checkpoints
    byte-identical.
  * Elastic restore: the (1, 2, 2) checkpoint restored at mesh (2, 2, 1)
    (tp 1, fsdp 4): the shards, reassembled here by mesh coordinates,
    equal the checkpoint's global arrays bit for bit, and the (2, 2, 1)
    trainer saves byte-identical files.  (The JAX package's ``replan``
    rejects this reshape for smoke qwen2-0.5b, whose single kv head is
    "replicated" at tp 2 and "sharded" at tp 1: the global shapes agree,
    and the port's restore checks the shapes itself.)
  * A pipeline run at pipe mesh (2, 1, 2) (smoke gpt-2.7b cut to 4
    layers, 4 microbatches, 2 steps) saves; an unpipelined trainer in
    this process restores it: the stage shards reassembled equal the
    restored global state bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_dist import run_group
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
POD_MESH, PIPE_MESH, ELASTIC_MESH = (1, 2, 2), (2, 1, 2), (2, 2, 1)
SEQ, BATCH = 32, 4
PIPE_BATCH, MICRO, LAYERS = 8, 4, 4
STEPS, EVERY, FAIL_AT = 6, 3, 4
SPEC = "tp=taco,grad_rs=sdp4bit"
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)
JAX_TIMEOUT_S = 300


def _qcfg(pkg):
    return pkg.smoke_config(pkg.get_config("qwen2-0.5b"))


def _gcfg(pkg):
    return dataclasses.replace(pkg.smoke_config(pkg.get_config("gpt-2.7b")),
                               n_layers=LAYERS)


def _port_model(shape, on_pipe_mesh=False, **kw):
    from repro_torch import configs
    from repro_torch.models.model import Model
    cfg = _gcfg(configs) if on_pipe_mesh else _qcfg(configs)
    fsdp = shape[1] if on_pipe_mesh else shape[0] * shape[1]
    return Model(cfg, configs.make_plan(cfg, shape[2], fsdp), device="cpu",
                 **kw)


def _f4_grads(shape, pipe):
    """Per-rank bf16 grads (raw int16) of every leaf, at rank 0's shard
    shapes (every rank's are the same)."""
    from repro_torch.models.model import _stacked_ids
    from repro_torch.optim import adamw
    kw = {"fsdp_axes": ("data",), "pipe": shape[0]} if pipe else {}
    model = _port_model(shape, pipe, **kw)
    specs = model.specs()
    stacked = _stacked_ids(specs)
    shapes = [model.shard(s, torch.empty(s.shape, device="meta"),
                          id(s) in stacked).shape
              for s in adamw.leaves(specs)]
    gen = np.random.default_rng(4 + shape[0])
    out = []
    for _ in range(4):
        row = []
        for s in shapes:
            x = gen.normal(size=s) * np.exp(gen.normal(size=s) * 2.0)
            row.append(torch.from_numpy(x.astype(np.float32)).bfloat16()
                       .view(torch.int16).numpy())
        out.append(row)
    return out


def jax_reference(inp: str, out: str) -> None:
    """The JAX package's ``finalize_grads`` at (1, 2, 2) and
    ``_finalize_pipe_grads`` at pipe (2, 1, 2) on four forced host
    devices, per rank, on the grads in ``inp``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat, configs
    from repro.compat import shard_map
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.train import pipeline_parallel as jpl
    assert len(jax.devices()) == 4
    with open(inp, "rb") as fh:
        grads = pickle.load(fh)
    res = {}
    for shape, pipe in ((POD_MESH, False), (PIPE_MESH, True)):
        if pipe:
            names = ("pipe", "data", "model")
            cfg = _gcfg(configs)
            model = Model(cfg, configs.make_plan(cfg, shape[2], shape[1]),
                          fsdp_axes=("data",), tp_axis="model")
            pc = jpl.PipeConfig(stages=shape[0], microbatches=MICRO)

            def fin(tree, model=model, pc=pc):
                return jpl._finalize_pipe_grads(tree, model, pc)
        else:
            names = ("pod", "data", "model")
            cfg = _qcfg(configs)
            model = Model(cfg, configs.make_plan(cfg, shape[2],
                                                 shape[0] * shape[1]))

            def fin(tree, model=model):
                return adamw.finalize_grads(tree, model)
        treedef = compat.tree_structure(model.specs(), is_leaf=adamw.IS_SPEC)
        per_rank = grads[shape]
        stacked = [jax.lax.bitcast_convert_type(
            jnp.asarray(np.stack([r[i] for r in per_rank])), jnp.bfloat16)
            for i in range(len(per_rank[0]))]

        def f(*xs, fin=fin, treedef=treedef):
            tree = compat.tree_unflatten(treedef, [x[0] for x in xs])
            return [x[None] for x in compat.tree_leaves(fin(tree))]
        spec = P(names)
        g = jax.jit(shard_map(f, mesh=jax.make_mesh(shape, names),
                              in_specs=tuple(spec for _ in stacked),
                              out_specs=[spec for _ in stacked],
                              check_vma=False))
        outs = g(*stacked)
        res[shape] = [[np.asarray(jax.lax.bitcast_convert_type(o, jnp.int16))
                       [r] for o in outs] for r in range(4)]
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


# --------------------------------------------------------------------------
# the port, on every rank
# --------------------------------------------------------------------------

def _int16(t):
    return t.detach().view(torch.int16).numpy().copy() \
        if t.dtype == torch.bfloat16 else t.detach().numpy().copy()


def _state(params, opt):
    from repro_torch.optim import adamw
    return ([_int16(p) for p in adamw.leaves(params)],
            [_int16(x) for x in adamw.leaves({k: opt[k] for k in
                                              ("master", "mu", "nu")})],
            opt["step"])


def _trainer(mesh, cfg_pipe, spec, ckpt_dir, steps, every, injector=None):
    from repro_torch import configs
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import pipeline_parallel as pl
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.train_step import build_train_step
    shape = mesh.shape
    cfg = _gcfg(configs) if cfg_pipe else _qcfg(configs)
    fsdp = shape[1] if cfg_pipe else shape[0] * shape[1]
    model = Model(cfg, configs.make_plan(cfg, shape[2], fsdp), device="cpu",
                  **mesh.model_kwargs())
    batch = PIPE_BATCH if cfg_pipe else BATCH
    data = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, batch), cfg)
    build = build_train_step
    if cfg_pipe:
        def build(model, ctx, oc):
            return pl.build_pipeline_train_step(
                model, ctx, oc, pl.PipeConfig(stages=shape[0],
                                              microbatches=MICRO))
    tc = TrainerConfig(total_steps=steps, ckpt_every=every,
                       ckpt_dir=str(ckpt_dir))
    return Trainer(model, mesh.parallel_ctx(from_spec(spec)),
                   OptConfig(**OPT), tc, data, injector=injector,
                   build_step=build)


def _mesh_task(rank, p, group, pl):
    from repro_torch.core.registry import from_spec
    from repro_torch.launch.mesh import PIPE_AXES, init_mesh
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import FailureInjector
    tmp = pathlib.Path(pl["dir"])
    res = {}
    # F4: the summed replicated grads
    for shape, pipe in ((POD_MESH, False), (PIPE_MESH, True)):
        mesh = init_mesh(shape, "cpu", **({"axes": PIPE_AXES} if pipe
                                          else {}))
        ctx = mesh.parallel_ctx(from_spec("baseline"))
        model = _port_model(shape, pipe, **mesh.model_kwargs())
        flat = [torch.from_numpy(a).view(torch.bfloat16)
                for a in pl["f4"][shape][rank]]
        it = iter(flat)
        grads = tree_map(lambda _: next(it), model.specs())
        out = adamw.finalize_grads(grads, model, ctx.comm, ctx.fsdp_groups,
                                   ctx.pipe_group)
        res[("f4", shape)] = [(str(g.dtype), _int16(g))
                              for g in adamw.leaves(out)]
    # restart after an injected failure, uninterrupted first
    mesh = init_mesh(POD_MESH, "cpu")
    for key, inj in (("ref", None), ("fail", FailureInjector([FAIL_AT]))):
        tr = _trainer(mesh, False, SPEC, tmp / key, STEPS, EVERY, inj)
        params, opt, hist = tr.run(resume=False)
        res[key] = _state(params, opt) + ([h["loss"] for h in hist],)
    # elastic: the (1, 2, 2) checkpoint restored at (2, 2, 1), saved again
    mesh = init_mesh(ELASTIC_MESH, "cpu")
    tr = _trainer(mesh, False, SPEC, tmp / "ref", STEPS, EVERY)
    params, opt, step = tr.try_restore(*tr.init_state()[:2])
    res["elastic"] = _state(params, opt) + (mesh.coords,)
    tr.tc.ckpt_dir = str(tmp / "elastic")
    tr.save(step, params, opt)
    # a pipeline run saves
    mesh = init_mesh(PIPE_MESH, "cpu", axes=PIPE_AXES)
    tr = _trainer(mesh, True, "baseline", tmp / "pipe", 2, 2)
    params, opt, _ = tr.run(resume=False)
    res["pipe"] = _state(params, opt) + (mesh.coords,)
    return res


# --------------------------------------------------------------------------
# this process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("restart")
    f4 = {POD_MESH: _f4_grads(POD_MESH, False),
          PIPE_MESH: _f4_grads(PIPE_MESH, True)}
    with open(tmp / "f4.pkl", "wb") as fh:
        pickle.dump(f4, fh)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with subprocess.Popen([sys.executable, __file__, str(tmp / "f4.pkl"),
                           str(tmp / "jax.pkl")],
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        try:
            port = run_group(tmp, 4, _mesh_task,
                             {"f4": f4, "dir": str(tmp / "ckpt")})
            log, _ = proc.communicate(timeout=JAX_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    return f4, ref, port, tmp / "ckpt"


def _summed_axes(shape, pipe):
    """Per leaf, whether the finalize sums it over any axis of ``shape``
    (every mesh axis here has two ranks but pod / data)."""
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    kw = {"fsdp_axes": ("data",), "pipe": shape[0]} if pipe else {}
    model = _port_model(shape, pipe, **kw)
    specs = model.specs()
    sizes = dict(zip(("pipe" if pipe else "pod", "data", "model"), shape))
    outside = adamw.leaves({k: tree_map(lambda _, k=k: k != "segments", v)
                            for k, v in specs.items()})
    out = []
    for s, o in zip(adamw.leaves(specs), outside):
        axes = model.replicated_grad_axes(s) + (("pipe",) if pipe and o
                                                else ())
        out.append(any(sizes[a] > 1 for a in axes))
    return out


@pytest.mark.parametrize("shape", [POD_MESH, PIPE_MESH],
                         ids=["1x2x2", "pipe2x1x2"])
def test_summed_replicated_grads_equal_the_reference_bitwise(both, shape,
                                                             capsys):
    f4, ref, port, _ = both
    pipe = shape == PIPE_MESH
    summed = _summed_axes(shape, pipe)
    assert any(summed) and not all(summed)
    unrounded = total = 0
    for r in range(4):
        got = port[r][("f4", shape)]
        for i, ((dtype, g), want) in enumerate(zip(got, ref[shape][r])):
            assert dtype == "torch.bfloat16", (i, dtype)
            np.testing.assert_array_equal(g, want, err_msg=f"leaf {i}")
            if not summed[i]:
                np.testing.assert_array_equal(g, f4[shape][r][i])
                continue
            # the parent port's f32 sum, unrounded, against the reference
            f32 = torch.from_numpy(want).view(torch.bfloat16).float()
            peers = [torch.from_numpy(f4[shape][q][i]).view(torch.bfloat16)
                     .float() for q in range(4)]
            exact = sum(peers[1:], peers[0])
            unrounded += int((exact != f32).sum())
            total += f32.numel()
    with capsys.disabled():
        print(f"\n  F4 {shape}: {unrounded} of {total} summed elements of "
              "the unrounded f32 sums differ from the reference's bf16")


def test_restart_after_injected_failure_at_1x2x2(both):
    _, _, port, tmp = both
    for r in range(4):
        a, b = port[r]["ref"], port[r]["fail"]
        assert a[2] == b[2] == STEPS
        for x, y in zip(a[0] + a[1], b[0] + b[1]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3] and len(a[3]) == STEPS
    _same_files(tmp / "ref" / f"step_{STEPS:08d}",
                tmp / "fail" / f"step_{STEPS:08d}")
    assert sorted(os.listdir(tmp / "ref")) == \
        [f"step_{s:08d}" for s in (EVERY, STEPS)]


def _same_files(a, b):
    import json
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    assert ma["leaves"] == mb["leaves"] and ma["step"] == mb["step"]
    assert ma.get("comm_spec") == mb.get("comm_spec")
    for leaf in ma["leaves"]:
        assert (a / leaf["file"]).read_bytes() == \
            (b / leaf["file"]).read_bytes(), leaf["key"]


def _load(step_dir):
    """The checkpoint's leaves by key, bf16 as raw int16."""
    import json
    man = json.loads((step_dir / "manifest.json").read_text())
    out = {}
    for leaf in man["leaves"]:
        a = np.load(step_dir / leaf["file"])
        out[leaf["key"]] = a.view(np.int16) if leaf["dtype"] == "bfloat16" \
            else a
    return out


def _reassemble(shape, per_rank, pipe):
    """Global leaves from per-rank shards, by mesh coordinates: the stage
    shards of a layer stack along dim 0, fsdp shards along ``fsdp_dim``,
    TP shards along ``tp_dim`` (the model's cut, undone independently)."""
    from repro_torch.launch.mesh import mesh_rank
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    model = _port_model(shape, pipe, **({"fsdp_axes": ("data",),
                                         "pipe": shape[0]} if pipe else {}))
    specs = adamw.leaves(model.specs())
    stack = adamw.leaves({k: tree_map(lambda _, k=k: k == "segments", v)
                          for k, v in model.specs().items()})
    out = []
    for i, (spec, st) in enumerate(zip(specs, stack)):
        def at(pp, f, m):
            if pipe:
                return per_rank[mesh_rank((pp, f, m), shape)][i]
            return per_rank[mesh_rank((f // shape[1], f % shape[1], m),
                                      shape)][i]
        stages = range(shape[0] if pipe and st else 1)
        fs = range((shape[1] if pipe else shape[0] * shape[1])
                   if spec.fsdp_dim is not None else 1)
        ms = range(shape[2] if spec.tp_dim is not None else 1)
        parts = []
        for pp in stages:
            rows = []
            for f in fs:
                cols = [at(pp, f, m) for m in ms]
                rows.append(np.concatenate(cols, spec.tp_dim)
                            if len(cols) > 1 else cols[0])
            parts.append(np.concatenate(rows, spec.fsdp_dim)
                         if len(rows) > 1 else rows[0])
        out.append(np.concatenate(parts, 0) if len(parts) > 1 else parts[0])
    return out


def test_elastic_restore_at_another_mesh_is_bitwise(both):
    _, _, port, tmp = both
    from repro_torch.launch.mesh import mesh_coords
    saved = _load(tmp / "ref" / f"step_{STEPS:08d}")
    keys = list(saved)                  # the manifest's (pytree) order
    params = [k for k in keys if k.startswith("['params']")]
    opt = [k for k in keys if k.startswith("['opt']") and "step" not in k]
    assert len(params) == 14 and len(opt) == 42
    for r in range(4):
        assert port[r]["elastic"][3] == mesh_coords(r, ELASTIC_MESH)
        assert port[r]["elastic"][2] == STEPS
    got_p = _reassemble(ELASTIC_MESH, [port[r]["elastic"][0]
                                       for r in range(4)], False)
    got_o = _reassemble_opt(ELASTIC_MESH, port, "elastic", False)
    for k, g in zip(params, got_p):
        np.testing.assert_array_equal(g, saved[k], err_msg=k)
    for k, g in zip(opt, got_o):
        np.testing.assert_array_equal(g, saved[k], err_msg=k)
    _same_files(tmp / "ref" / f"step_{STEPS:08d}",
                tmp / "elastic" / f"step_{STEPS:08d}")


def _reassemble_opt(shape, port, key, pipe):
    """master, mu, nu (in that order) reassembled, as their sorted keys
    list them."""
    n = len(port[0][key][0])
    out = []
    for j in range(3):
        out += _reassemble(shape, [port[r][key][1][j * n:(j + 1) * n]
                                   for r in range(4)], pipe)
    return out


def test_pipeline_checkpoint_restores_unpipelined(both):
    """A pipe-mesh run's checkpoint restored by an unpipelined trainer at
    mesh (1, 1, 1): the stages' shards reassembled equal the restored
    global state bit for bit."""
    from repro_torch import configs
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import replan
    from repro_torch.train.trainer import Trainer, TrainerConfig
    _, _, port, tmp = both
    cfg = _gcfg(configs)
    plan = configs.make_plan(cfg, 1, 1)
    assert replan(cfg, configs.make_plan(cfg, PIPE_MESH[2], PIPE_MESH[1]),
                  1, 1).ok
    tr = Trainer(Model(cfg, plan, device="cpu"),
                 ParallelCtx(plan=from_spec("baseline")),
                 adamw.OptConfig(**OPT),
                 TrainerConfig(total_steps=2, ckpt_dir=str(tmp / "pipe")),
                 SyntheticLM(DataConfig(cfg.vocab_size, SEQ, PIPE_BATCH)))
    params, opt, step = tr.try_restore(*tr.init_state()[:2])
    assert step == 2 and opt["step"] == 2
    want_p = _reassemble(PIPE_MESH, [port[r]["pipe"][0] for r in range(4)],
                         True)
    want_o = _reassemble_opt(PIPE_MESH, port, "pipe", True)
    got = _state(params, opt)
    for a, b in zip(got[0] + got[1], want_p + want_o):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    jax_reference(sys.argv[1], sys.argv[2])
