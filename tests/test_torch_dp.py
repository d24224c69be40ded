"""Data parallelism and FSDP over a ``pod x data x model`` mesh of processes,
with the SDP4bit gradient codec, held against the JAX package at the same
mesh.

One training step of smoke qwen2-0.5b (2 layers, d 128, vocab 503; global
batch 4 x seq 64), from the same seeded weights and the same numpy batch,
at meshes (1, 2, 2) and (2, 2, 1):

  * the port: a gloo world of four spawned processes (as
    ``tests/test_torch_dist.py`` runs it), the mesh's groups built by
    ``launch.mesh.init_mesh``, the weights carried across by
    ``Model.from_jax_params`` (each rank keeps its TP and fsdp shard), the
    batch cut by ``Model.batch_slice``, the step the launcher's
    (``train.train_step.build_train_step``, AdamW included); the sharded
    grads and master weights are reassembled by mesh coordinates;
  * the JAX package: a subprocess with four forced host devices (as
    ``tests/test_torch_dist_ref.py`` runs it), ``jax.make_mesh`` at the
    same shape, the reference's loss (summed over the dp axes), grads,
    ``finalize_grads`` and ``adamw_update`` in one ``shard_map``.  It also
    writes ``mesh.devices``, against which the port's rank layout is held.

Both compute in f32 (``COMPUTE_DTYPE`` set in both, as
``tests/test_torch_dist_ref.py`` does).

Bounds, relative.  Identity plan: loss 1e-6, flattened gradients 1e-5,
updated master weights 1e-5 (measured 7.6e-8, 4.6e-7 to 5.3e-7 and 9.7e-7
to 1.3e-6).  ``grad_rs=sdp4bit`` (the forward is not compressed): loss
1e-6; every compressed gradient hop of the step, at the pod and at the
data stage, on every rank, against the JAX codec on the same per-rank
inputs, to the parity rule of ``core/dp_compress.py`` (codes at most one
apart; apart from codes at a tie, at most 1e-4 of the step's int4 codes
apart; scales rtol 1e-5; each decoded block within what its differing
codes allow); the grads and the updated master weights within
:data:`SDP_BOUNDS` (see :func:`test_sdp4bit_step_matches_jax_at_the_same_mesh`).

Ties.  A data stage re-encodes the decoded output of the pod stage.  Where
a peer's slot boundary cuts a 128-block of the pod stage, the data stage
rotates a dyadic slice of a rotated block, which averages its codes over
cosets: ``z / s`` lands on ``k + 0.5`` exactly, and the last bit of the
rotation decides the code.  At mesh (2, 2, 1) 909 of the step's 2.1e6
codes differ from the JAX codec's, every one at such a tie (0 at (1, 2,
2), whose pod stage has one rank); the ragged collectives show 8 and 24,
all at ties.

Within the port: the ring ``grad_rs=sdp4bit:chunks=4`` (pipelined and
serial) gives the monolithic hop's loss, grads and master weights bit for
bit, and its compressed collectives over the fsdp groups on ragged
(padded) inputs equal the monolithic ones bit for bit; the identity plan
at mesh (1, 2, 1) equals (1, 1, 1) on the same global batch within float
reassociation (loss 1e-6, grads 1e-5); at mesh (1, 1, 1), without
``torch.distributed``, ``grad_rs=sdp4bit`` runs the codec at both fsdp
stages of every weight gather, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from test_torch_dist import rel, run_group
from test_torch_dist_ref import _f32
from repro.core.registry import codec_from_spec as jcodec_from_spec
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = ((1, 2, 2), (2, 2, 1))
SEQ, BATCH = 64, 4
SDP = "grad_rs=sdp4bit"
RINGS = ("grad_rs=sdp4bit:chunks=4", "grad_rs=sdp4bit:chunks=4:schedule=serial")
SPECS = ("baseline", SDP)
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)
#: (loss, grads, master weights) relative bounds of the identity plan
IDENTITY_BOUNDS = (1e-6, 1e-5, 1e-5)
#: the sdp4bit step's (grads, updated master weights) against the JAX
#: package's: about twice the spread of the port against itself with its
#: rotation as an f32 matmul (see the test)
SDP_BOUNDS = (3e-2, 6e-3)
JAX_TIMEOUT_S = 300


def _tree(tp):
    """The JAX package's global f32 weights of the smoke model at tp."""
    import jax
    from repro.configs import get_config, make_plan, smoke_config
    from repro.models.model import Model
    cfg = smoke_config(get_config("qwen2-0.5b"))
    return jax.device_get(Model(cfg, make_plan(cfg, tp, 1)).init(
        jax.random.PRNGKey(0), dtype=jnp.float32))


def jax_reference(out: str) -> None:
    """The JAX package on four forced host devices, at each mesh of
    MESHES: writes the device layout and, per spec, the loss, the global
    grads (after ``finalize_grads``), the global master weights after one
    AdamW update and the grad norm."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    from repro.compat import shard_map
    from repro.configs import get_config, make_plan, smoke_config
    from repro.core.collectives import psum_exact
    from repro.core.parallel import ParallelCtx
    from repro.core.registry import from_spec
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.train.train_step import dp_axes
    for mod in (jl, ja, jt):
        mod.COMPUTE_DTYPE = jnp.float32
    assert len(jax.devices()) == 4
    cfg = smoke_config(get_config("qwen2-0.5b"))
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    oc = adamw.OptConfig(**OPT)
    res = {"batch": {k: np.asarray(v) for k, v in batch.items()}}
    for shape in MESHES:
        model = Model(cfg, make_plan(cfg, shape[2], shape[0] * shape[1]))
        params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        mesh = jax.make_mesh(shape, ("pod", "data", "model"))
        pspecs, bspecs = model.partition_specs(), model.batch_pspecs()
        ospecs = adamw.opt_state_pspecs(pspecs)

        def put(tree, specs, mesh=mesh):
            return jax.tree.map(lambda x, s: jax.device_put(
                x, NamedSharding(mesh, s)), tree, specs)
        args = (put(params, pspecs), put(adamw.init_opt_state(params), ospecs),
                {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                 for k, v in batch.items()})
        row = {"devices": np.vectorize(lambda d: d.id)(mesh.devices)}
        for spec in SPECS:
            ctx = ParallelCtx(plan=from_spec(spec))

            def step(q, o, b, ctx=ctx, model=model):
                def loss_fn(qq):
                    loss_sum, count, _ = model.loss_parts(qq, b, ctx)
                    loss_sum = psum_exact(loss_sum, dp_axes(model))
                    count = jax.lax.psum(jax.lax.stop_gradient(count),
                                         dp_axes(model))
                    return loss_sum / jnp.maximum(count, 1.0)
                loss, grads = jax.value_and_grad(loss_fn)(q)
                grads = adamw.finalize_grads(grads, model)
                _, new, m = adamw.adamw_update(grads, o, oc, model)
                return loss, grads, new["master"], m["grad_norm"]
            f = jax.jit(shard_map(step, mesh=mesh,
                                  in_specs=(pspecs, ospecs, bspecs),
                                  out_specs=(P(), pspecs, pspecs, P()),
                                  check_vma=False))
            loss, grads, master, gnorm = f(*args)
            leaves = jax.tree_util.tree_leaves
            row[spec] = (float(loss),
                         [np.asarray(g, np.float32) for g in leaves(grads)],
                         [np.asarray(w, np.float32) for w in leaves(master)],
                         float(gnorm))
        res[shape] = row
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


# --------------------------------------------------------------------------
# the port, on every rank
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _recording(hops, ctx):
    """Within the block, each one-group hop of a compressed collective over
    the fsdp groups under an ``Sdp4BitCodec`` appends ``(axis, kind, dim,
    input, output)`` to ``hops``; the axis is the group's place in the
    ``(pod, data)`` tuple, taken in the order the hierarchical impl walks
    it (a scatter outermost first, a gather innermost first), and the
    group the impl passes must be that axis' group."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.codecs import Sdp4BitCodec
    names = ("_ag_impl", "_rs_impl", "_ag_one", "_rs_one")
    saved = {name: getattr(cc, name) for name in names}
    walk: list = []

    def impl(x, group, dim, codec, _fn, _order):
        walk[:] = list(_order) if group is ctx.fsdp_groups else []
        return _fn(x, group, dim, codec)

    def one(x, group, dim, codec, _fn, _kind):
        out = _fn(x, group, dim, codec)
        if walk and isinstance(codec, Sdp4BitCodec):
            axis = walk.pop(0)
            assert group is ctx.fsdp_groups[("pod", "data").index(axis)]
            hops.append((axis, _kind, dim, x.detach().float().numpy().copy(),
                         out.detach().float().numpy().copy()))
        return out
    cc._ag_impl = lambda *a: impl(*a, saved["_ag_impl"], ("data", "pod"))
    cc._rs_impl = lambda *a: impl(*a, saved["_rs_impl"], ("pod", "data"))
    cc._ag_one = lambda *a: one(*a, saved["_ag_one"], "ag")
    cc._rs_one = lambda *a: one(*a, saved["_rs_one"], "rs")
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cc, name, fn)


def _port_step(model, ctx, tree, batch):
    """One launcher step: (loss, grad norm, finalized grads, master weights
    after the update), the grads caught on their way into AdamW."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    params = model.from_jax_params(tree)
    caught = {}
    update = adamw.adamw_update

    def spy(params, grads, *a, **k):
        caught["grads"] = [g.float().numpy().copy()
                           for g in adamw.leaves(grads)]
        return update(params, grads, *a, **k)
    adamw.adamw_update = spy
    try:
        step = build_train_step(model, ctx, adamw.OptConfig(**OPT))
        _, opt, m = step(params, adamw.init_opt_state(params), batch)
    finally:
        adamw.adamw_update = update
    return (float(m["loss"]), float(m["grad_norm"]), caught["grads"],
            [w.numpy().copy() for w in adamw.leaves(opt["master"])])


def _smoke_model(tp, fsdp, tp_rank=0, fsdp_rank=0):
    from repro_torch import configs
    from repro_torch.models.model import Model
    cfg = configs.smoke_config(configs.get_config("qwen2-0.5b"))
    return Model(cfg, configs.make_plan(cfg, tp, fsdp), device="cpu",
                 tp_rank=tp_rank, fsdp_rank=fsdp_rank)


def _ragged(rank, shape):
    """Per-rank inputs of the collectives check: per-peer slots of 800,
    400 and 300 elements (each padded to the 128 granule)."""
    gen = np.random.default_rng(100 + rank)
    f = shape[0] * shape[1]
    return (torch.from_numpy(tp_like(gen, (2, 4 * f, 50))),
            torch.from_numpy(tp_like(gen, (2, 3, 50))))


def _collectives(ctx, shape, rank, hops):
    """The fsdp tuple's compressed reduce-scatter and all-gather (and the
    all-gather's backward) on ragged inputs under sdp4bit, monolithic
    (recorded hop by hop) and on the ring."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.registry import codec_from_spec
    rs_in, ag_in = _ragged(rank, shape)
    out = {}
    for spec in ("sdp4bit", "sdp4bit:chunks=4",
                 "sdp4bit:chunks=4:schedule=serial"):
        c = codec_from_spec(spec)
        with (_recording(hops, ctx) if spec == "sdp4bit"
              else contextlib.nullcontext()):
            rs = cc.psum_scatter_c(rs_in, ctx.fsdp_groups, 1, c, c)
            x = ag_in.clone().requires_grad_(True)
            ag = cc.all_gather_c(x, ctx.fsdp_groups, 1, c, c)
            ag.backward(torch.ones_like(ag))
        out[spec] = [rs.numpy(), ag.detach().numpy(), x.grad.numpy()]
    return out


def _dp_task(rank, p, group, pl):
    import torch.distributed as dist

    from repro_torch.core import ash
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.launch.mesh import init_mesh
    _f32()
    glob = {k: torch.from_numpy(v) for k, v in pl["batch"].items()}
    res = {}
    for shape in MESHES:
        mesh = init_mesh(shape, "cpu")
        base = mesh.parallel_ctx(from_spec("baseline"))
        model = _smoke_model(shape[2], shape[0] * shape[1], base.tp_rank,
                             base.fsdp_rank)
        batch = model.batch_slice(glob)
        res[shape] = {"coords": mesh.coords, "fsdp_rank": base.fsdp_rank,
                      "hops": [], "coll_hops": []}
        for key, spec in (*zip(SPECS + RINGS, SPECS + RINGS),
                          ("f32 rotation", SDP)):
            ctx = mesh.parallel_ctx(from_spec(spec))
            rotate = ash._rotate
            if key == "f32 rotation":
                ash._rotate = lambda z, h: z @ h
            try:
                with (_recording(res[shape]["hops"], ctx) if key == SDP
                      else contextlib.nullcontext()):
                    res[shape][key] = _port_step(
                        model, ctx, pl["trees"][shape[2]], batch)
            finally:
                ash._rotate = rotate
        res[shape]["coll"] = _collectives(mesh.parallel_ctx(from_spec(SDP)),
                                          shape, rank, res[shape]["coll_hops"])
    # the identity plan over a data axis of 2 (ranks 0 and 1, 2 and 3)
    pairs = [dist.new_group(r) for r in ([0, 1], [2, 3])]
    ctx = ParallelCtx(plan=from_spec("baseline"),
                      fsdp_groups=(None, pairs[rank // 2]))
    model = _smoke_model(1, 2, 0, ctx.fsdp_rank)
    res["dp2"] = _port_step(model, ctx, pl["trees"][1],
                            model.batch_slice(glob))
    res["dp1"] = _port_step(_smoke_model(1, 1), ParallelCtx(),
                            pl["trees"][1], glob)
    return res


# --------------------------------------------------------------------------
# reassembly and the references in this process
# --------------------------------------------------------------------------

def _global(shape, per_rank):
    """Global leaves from per-rank shard leaves (``per_rank[r][i]``): TP
    shards concatenated along ``tp_dim``, fsdp shards (pod-major) along
    ``fsdp_dim``; a replicated dim is taken from index 0 of its axis."""
    from repro_torch.launch.mesh import mesh_rank
    from repro_torch.optim import adamw
    specs = adamw.leaves(_smoke_model(shape[2], shape[0] * shape[1])
                         .specs())
    d = shape[1]
    out = []
    for i, spec in enumerate(specs):
        fs = range(shape[0] * d if spec.fsdp_dim is not None else 1)
        ms = range(shape[2] if spec.tp_dim is not None else 1)
        rows = []
        for f in fs:
            cols = [per_rank[mesh_rank((f // d, f % d, m), shape)][i]
                    for m in ms]
            rows.append(cols[0] if len(cols) == 1
                        else np.concatenate(cols, axis=spec.tp_dim))
        out.append(rows[0] if len(rows) == 1
                   else np.concatenate(rows, axis=spec.fsdp_dim))
    return out


def _flat(leaves):
    return np.concatenate([a.ravel() for a in leaves])


def _pad(a, mult):
    rem = (-a.shape[-1]) % mult
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, rem)])


def _check_hops(shape, hops, tally, axes=None):
    """Every recorded hop, on every rank, against the JAX codec on the same
    per-rank inputs (the peers of the rank's group along the hop's axis of
    a mesh of ``axes``, the pod mesh's by default),
    to the parity rule of ``core/dp_compress.py``; the rank's recorded
    output must be the port codec's decode of the same wires bit for bit.
    ``tally`` sums the codes and flipped codes."""
    from repro_torch.core import dp_compress
    from repro_torch.core.codecs import Sdp4BitCodec
    from repro_torch.launch.mesh import AXES, axis_ranks
    import jax
    axes = axes or AXES
    codec, jcodec = Sdp4BitCodec(), jcodec_from_spec("sdp4bit")
    # one compile a shape, not one a primitive
    jencode = jax.jit(jcodec.encode_wire)
    jdecode = jax.jit(jcodec.decode_wire, static_argnums=(1, 2))
    jdecode_sum = jax.jit(jcodec.decode_sum_wire, static_argnums=(1, 2))
    block = codec.block
    ranks_all = range(len(hops))
    assert len({len(h) for h in hops}) == 1 and hops[0]
    for k, (axis, kind, dim, _, _) in enumerate(hops[0]):
        assert all(hops[r][k][:3] == (axis, kind, dim) for r in ranks_all)
        for ranks in axis_ranks(shape, axis, axes):
            p = len(ranks)
            xs = [hops[r][k][3] for r in ranks]
            if kind == "rs":
                rows = [np.moveaxis(x, dim, 0).reshape(p, -1) for x in xs]
            else:
                rows = [x.reshape(1, -1) for x in xs]
            n = rows[0].shape[-1]
            padded = [_pad(r, block) for r in rows]
            pn = padded[0].shape[-1]
            wires = np.stack([codec.encode_wire(torch.from_numpy(r)).numpy()
                              for r in padded])           # (peer, row, bytes)
            jwires = np.stack([np.asarray(jencode(jnp.asarray(r)))
                               for r in padded])
            for i, r in enumerate(ranks):
                if kind == "rs":
                    w, jw = wires[:, i], jwires[:, i]   # rows for peer i
                    par = dp_compress.check_wire_parity(
                        torch.from_numpy(w), torch.from_numpy(jw), pn, block,
                        x=torch.from_numpy(np.stack([q[i] for q in padded])),
                        flip_fraction=1.0)
                    dec = codec.decode_sum_wire(torch.from_numpy(w), pn,
                                                torch.float32)
                    jdec = np.asarray(jdecode_sum(
                        jnp.asarray(jw), pn, jnp.float32))
                    bound = par["bound"].sum(dim=0)
                    moved = np.moveaxis(xs[0], dim, 0)
                    mine = np.moveaxis(dec.numpy()[:n].reshape(
                        moved.shape[0] // p, *moved.shape[1:]), 0, dim)
                else:
                    w, jw = wires[:, 0], jwires[:, 0]
                    par = dp_compress.check_wire_parity(
                        torch.from_numpy(w), torch.from_numpy(jw), pn, block,
                        x=torch.from_numpy(np.concatenate(padded)),
                        flip_fraction=1.0)
                    dec = codec.decode_wire(torch.from_numpy(w), pn,
                                            torch.float32)
                    jdec = np.asarray(jdecode(
                        jnp.asarray(jw), pn, jnp.float32))
                    bound = par["bound"]
                    x = xs[0]
                    stacked = dec.numpy()[:, :n].reshape(p, *x.shape)
                    size = list(x.shape)
                    size[dim] *= p
                    mine = np.moveaxis(stacked, 0, dim).reshape(size)
                dp_compress.check_decoded(dec, torch.from_numpy(np.array(jdec)), bound,
                                          block)
                np.testing.assert_array_equal(hops[r][k][4], mine)
                if i == 0 or kind == "rs":
                    for key in ("codes", "flipped", "at_ties"):
                        tally[key] += par[key]
                tally["hops"] += 1


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX package's runs (a subprocess) and the port's (a gloo world of
    four processes), started together."""
    tmp = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with subprocess.Popen([sys.executable, __file__, str(tmp / "jax.pkl")],
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        try:
            from repro.configs import get_config, smoke_config
            from repro.data.pipeline import DataConfig, SyntheticLM
            cfg = smoke_config(get_config("qwen2-0.5b"))
            batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH),
                                cfg).batch(0)
            nb = {k: np.asarray(v).astype(np.float32 if k == "mask"
                                          else np.int64)
                  for k, v in batch.items()}
            port = run_group(tmp, 4, _dp_task,
                             {"trees": {tp: _tree(tp) for tp in (1, 2)},
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
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=["1x2x2", "2x2x1"])
def test_rank_layout_is_the_jax_meshs(both, shape):
    """Port rank r sits where ``jax.make_mesh`` puts device r, and its
    fsdp index is pod-major."""
    ref, port = both
    from repro_torch.launch.mesh import mesh_coords
    devices = ref[shape]["devices"]
    for r in range(4):
        coords = mesh_coords(r, shape)
        assert port[r][shape]["coords"] == coords
        assert devices[coords] == r
        assert port[r][shape]["fsdp_rank"] == coords[0] * shape[1] + coords[1]


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 4), (2, 16, 16),
                                   (4, 1, 2)])
def test_mesh_axis_info_matches_jax(shape):
    """``mesh_axis_info`` against the JAX package's on a stand-in mesh with
    the same axis names and sizes (the reference reads only those)."""
    import types

    from repro.launch.mesh import mesh_axis_info as jinfo
    from repro_torch.launch.mesh import Mesh, mesh_axis_info
    names = ("pod", "data", "model")
    stand_in = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, shape)))
    assert mesh_axis_info(Mesh(shape)) == jinfo(stand_in)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2x2", "2x2x1"])
def test_identity_step_matches_jax_at_the_same_mesh(both, shape):
    ref, port = both
    loss_b, grad_b, master_b = IDENTITY_BOUNDS
    jl_, jgrads, jmaster, jgnorm = ref[shape]["baseline"]
    runs = [port[r][shape]["baseline"] for r in range(4)]
    assert len({(l, g) for l, g, _, _ in runs}) == 1   # every rank agrees
    loss, gnorm = runs[0][:2]
    assert abs(loss - jl_) / abs(jl_) < loss_b, (loss, jl_)
    assert abs(gnorm - jgnorm) / jgnorm < grad_b
    grads = _global(shape, [r[2] for r in runs])
    assert [g.shape for g in grads] == [g.shape for g in jgrads]
    assert rel(_flat(grads), _flat(jgrads)) < grad_b
    master = _global(shape, [r[3] for r in runs])
    assert rel(_flat(master), _flat(jmaster)) < master_b


@pytest.mark.parametrize("shape", MESHES, ids=["1x2x2", "2x2x1"])
def test_sdp4bit_step_matches_jax_at_the_same_mesh(both, shape):
    """Under ``grad_rs=sdp4bit`` the forward is not compressed: the loss is
    held to the identity bound.  Every compressed gradient hop of the step
    (both fsdp stages of each weight gather's backward, every rank) is held
    against the JAX codec on the same per-rank inputs.

    The grads and the updated master weights: a code decided by a tie
    (module docstring) moves its whole 128-block by a code step, and
    AdamW's first step moves every weight by about lr x sign(g), so such a
    block's small elements move up to 2 lr apart.  The port against itself
    with only its rotation changed to an f32 matmul (which decides the
    ties as the JAX package's does, or not) spreads the grads 3.4e-7 at
    (1, 2, 2) and 1.2e-2 at (2, 2, 1), the master weights 5.3e-6 and
    3.0e-3; against the JAX package the port measures 5.6e-4 and 1.4e-2
    (grads), 2.3e-4 and 3.0e-3 (weights).  Bounds: about twice the largest
    spread, 3e-2 and 6e-3.  The codec itself (sdp4bit against the identity
    plan) moves the weights 1.3e-2 to 1.4e-2."""
    ref, port = both
    jl_, jgrads, jmaster, _ = ref[shape][SDP]
    runs = [port[r][shape][SDP] for r in range(4)]
    assert len({(l, g) for l, g, _, _ in runs}) == 1
    assert abs(runs[0][0] - jl_) / abs(jl_) < IDENTITY_BOUNDS[0]
    tally = dict(codes=0, flipped=0, at_ties=0, hops=0)
    hops = [port[r][shape]["hops"] for r in range(4)]
    # every weight gather's backward crosses both stages: pod, then data
    assert [h[0] for h in hops[0]] == ["pod", "data"] * 16
    _check_hops(shape, hops, tally)
    assert tally["flipped"] - tally["at_ties"] <= 1e-4 * tally["codes"], \
        tally
    grad_b, master_b = SDP_BOUNDS
    grads = _global(shape, [r[2] for r in runs])
    assert rel(_flat(grads), _flat(jgrads)) < grad_b
    master = _global(shape, [r[3] for r in runs])
    assert rel(_flat(master), _flat(jmaster)) < master_b
    base = _global(shape, [port[r][shape]["baseline"][3] for r in range(4)])
    assert rel(_flat(master), _flat(base)) > 2 * master_b   # the codec ran


def test_sdp4bit_rotations_last_bit_spreads_as_far(both):
    """The port against itself with its rotation as an f32 matmul stays
    within SDP_BOUNDS (the measurement the bounds are set from)."""
    _, port = both
    for shape in MESHES:
        a = [port[r][shape][SDP] for r in range(4)]
        b = [port[r][shape]["f32 rotation"] for r in range(4)]
        assert a[0][0] == b[0][0]                   # the forward: no codec
        for i, bound in zip((2, 3), SDP_BOUNDS):
            spread = rel(_flat(_global(shape, [r[i] for r in a])),
                         _flat(_global(shape, [r[i] for r in b])))
            assert spread < bound / 1.5, (shape, i, spread)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2x2", "2x2x1"])
@pytest.mark.parametrize("spec", RINGS)
def test_sdp4bit_ring_step_is_the_monolithic_hop_bit_for_bit(both, shape,
                                                             spec):
    _, port = both
    for r in range(4):
        ring, mono = port[r][shape][spec], port[r][shape][SDP]
        assert ring[:2] == mono[:2]
        for a, b in zip(ring[2] + ring[3], mono[2] + mono[3]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2x2", "2x2x1"])
def test_sdp4bit_collectives_over_the_fsdp_groups(both, shape):
    """Ragged slots (padded to the granule) through the fsdp tuple: each
    hop against the JAX codec, and the ring (pipelined, serial) equal to
    the monolithic hop bit for bit, the all-gather's backward included."""
    _, port = both
    tally = dict(codes=0, flipped=0, at_ties=0, hops=0)
    _check_hops(shape, [port[r][shape]["coll_hops"] for r in range(4)],
                tally)
    assert tally["flipped"] - tally["at_ties"] <= 1e-4 * tally["codes"], \
        tally
    for r in range(4):
        coll = port[r][shape]["coll"]
        for spec in ("sdp4bit:chunks=4", "sdp4bit:chunks=4:schedule=serial"):
            for a, b in zip(coll[spec], coll["sdp4bit"]):
                np.testing.assert_array_equal(a, b)
        rs_in, ag_in = _ragged(r, shape)
        assert coll["sdp4bit"][0].shape == (2, 4, 50)
        assert coll["sdp4bit"][1].shape == (2, 3 * shape[0] * shape[1], 50)
        assert coll["sdp4bit"][2].shape == tuple(ag_in.shape)


def test_identity_data_parallel_equals_one_process(both):
    """Mesh (1, 2, 1) against (1, 1, 1) on the same global batch."""
    _, port = both
    for pair in ((0, 1), (2, 3)):
        runs = [port[r]["dp2"] for r in pair]
        one = port[pair[0]]["dp1"]
        assert runs[0][:2] == runs[1][:2]
        assert abs(runs[0][0] - one[0]) / one[0] < 1e-6
        grads = _global((1, 2, 1), {0: runs[0][2], 1: runs[1][2]})
        assert rel(_flat(grads), _flat(one[2])) < 1e-5
        master = _global((1, 2, 1), {0: runs[0][3], 1: runs[1][3]})
        assert rel(_flat(master), _flat(one[3])) < 1e-6


def test_sdp4bit_at_one_rank_runs_both_stages_as_the_reference(
        monkeypatch):
    """Without ``torch.distributed`` (mesh 1,1,1) every weight gather's
    backward runs the codec at the pod and then the data stage (the JAX
    package quantizes at every axis of its fsdp tuple, size 1 included);
    each such hop against the JAX codec on the same input."""
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.models.transformer as tt
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    for mod in (tl, ta, tt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    model = _smoke_model(1, 1)
    ctx = ParallelCtx(plan=from_spec(SDP))
    batch = SyntheticLM(DataConfig(model.cfg.vocab_size, 32, 2)).batch(0)
    hops = []
    with _recording(hops, ctx):
        loss, gnorm, _, _ = _port_step(model, ctx, _tree(1), batch)
    assert np.isfinite(loss) and np.isfinite(gnorm)
    assert [h[0] for h in hops] == ["pod", "data"] * 16
    tally = dict(codes=0, flipped=0, at_ties=0, hops=0)
    _check_hops((1, 1, 1), [hops], tally)
    assert tally["hops"] == 32
    assert tally["flipped"] - tally["at_ties"] <= 1e-4 * tally["codes"], \
        tally


if __name__ == "__main__":
    jax_reference(sys.argv[1])
