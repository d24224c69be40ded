"""Compressed training at tp = P held against the JAX package at tp = P.

One training step's loss and gradients of smoke qwen2-0.5b (2 layers,
d 128, vocab 503; batch 2 x seq 64), from the same seeded weights and the
same numpy batch, at P = 2 and 4, under the identity plan and under the
paper's chunked ring ``tp=taco:folded:chunks=4``:

  * the port: a gloo group of P spawned processes (as
    ``tests/test_torch_dist.py`` runs it), the weights carried across by
    ``Model.from_jax_params``, the sharded grads reassembled;
  * the JAX package: a subprocess with ``XLA_FLAGS=
    --xla_force_host_platform_device_count=P`` (as ``tests/test_pipeline.py``
    runs ``tests/multidev/check_tp_model.py``), a (1, 1, P) mesh, the
    spec's ``taco`` with the oracle implementation (``taco:jnp``), the
    grads after the reference's ``finalize_grads`` (run as
    ``python tests/test_torch_dist_ref.py P OUT``); it also runs the
    monolithic hop ``tp=taco:folded``, which it holds bit-identical to its
    ring hop by hop.

Both packages compute in f32 here (``COMPUTE_DTYPE`` set in both, as
``tests/test_torch_train.py`` does for its per-tensor check): in bf16 the
two frameworks round at different places, which costs 2e-2 of the
gradients already at tp = 1.

Bounds, relative.  Identity plan: loss 1e-4, flattened gradients 1e-3
(float reassociation); measured loss 1.5e-7 and grads 3.8e-7 at both P.
Ring: loss 1e-3; measured 9.8e-5 (P = 2) and 5.5e-5 (P = 4).

Every compressed hop of the ring step, forward and backward, on every
rank, is held against the JAX codec on the same per-rank inputs within
1e-2 (:func:`test_every_compressed_hop_of_the_step_matches_the_jax_codec`);
measured at most 2.4e-3 over the 26 hops at P = 2 and at P = 4, most of
them within 1e-6.  A codec that differed from the reference would miss it
by far: two independent quantizations of one hop differ by about 3.7e-2
(each is 2.65e-2 from its input).  The per-hop error is a few payload
codes in 1e4 on the other side of a rounding boundary: the port rotates
with f64 accumulation, the oracle with an f32 matmul, and the model's own
float differences move the hop inputs by ~2e-7.  One flipped code moves
its whole 256-element block by up to a code step after the inverse
rotation (two flips in one rank's 8192 elements: 2.4e-3 of that hop's
output).

The whole step amplifies such flips: each compressed hop turns a small
difference of its input into whole-block differences of its output, so
the flattened gradients of two runs that differ only in the last bit
spread by 1.6e-2 to 4.2e-2, whichever package runs them: the port against
itself with its rotation as an f32 matmul, 1.6e-2 (P = 2) and 3.7e-2
(P = 4); the reference's own ring against its own monolithic hop, which
it holds bit-identical hop by hop, 3.4e-2 (P = 2) and 4.2e-2 (P = 4), its
loss 9.8e-5 and 9.6e-5 apart.  So the ring's gradients are held against
JAX within 7.5e-2, about twice the largest of these spreads (a bound of
1e-2 would fail the reference against itself); measured 3.0e-2 (P = 2)
and 3.4e-2 (P = 4).  Each run's codec error against its identity plan is
5.2e-2 to 5.6e-2.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_dist import (_flat, _jax_ag, _jax_codec, _jax_rs,
                             _loss_grads, _port_model, _reassemble, rel,
                             run_group)
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ, BATCH = 64, 2
RING_SPEC = "tp=taco:folded:chunks=4"
MONO_SPEC = "tp=taco:folded"
SPECS = ("baseline", RING_SPEC)
#: (loss, grads) relative bounds; see the module docstring
BOUNDS = {"baseline": (1e-4, 1e-3), RING_SPEC: (1e-3, 7.5e-2)}
#: one compressed hop's output against the JAX codec's, relative
HOP_BOUND = 1e-2
JAX_TIMEOUT_S = 300


def _jax_spec(spec):
    return spec.replace("taco", "taco:jnp", 1)


def jax_reference(p: int, out: str) -> None:
    """The JAX package at tp = ``p`` on ``p`` forced host devices: writes
    the global f32 weights, the batch and, per spec, the loss and the
    global gradients (pickled) to ``out``."""
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    from repro.compat import shard_map
    from repro.configs import get_config, make_plan, smoke_config
    from repro.core.parallel import ParallelCtx
    from repro.core.registry import from_spec
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    from repro.optim import adamw
    for mod in (jl, ja, jt):
        mod.COMPUTE_DTYPE = jnp.float32
    assert len(jax.devices()) == p
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, p, 1))
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    mesh = jax.make_mesh((1, 1, p), ("pod", "data", "model"))
    pspecs, bspecs = model.partition_specs(), model.batch_pspecs()
    placed = jax.tree.map(lambda x, s: jax.device_put(
        x, NamedSharding(mesh, s)), params, pspecs)
    placed_batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                    for k, v in batch.items()}
    res = {"tree": jax.device_get(params),
           "batch": {k: np.asarray(v) for k, v in batch.items()}}
    for spec in (*SPECS, MONO_SPEC):
        ctx = ParallelCtx(plan=from_spec(_jax_spec(spec)))

        def step(q, b, ctx=ctx):
            def loss_fn(qq):
                loss_sum, count, _ = model.loss_parts(qq, b, ctx)
                return loss_sum / jnp.maximum(count, 1.0)
            loss, grads = jax.value_and_grad(loss_fn)(q)
            return loss, adamw.finalize_grads(grads, model)
        f = jax.jit(shard_map(step, mesh=mesh, in_specs=(pspecs, bspecs),
                              out_specs=(P(), pspecs), check_vma=False))
        loss, grads = f(placed, placed_batch)
        res[spec] = (float(loss), [np.asarray(g, np.float32) for g in
                                   jax.tree_util.tree_leaves(grads)])
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def _f32():
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.models.transformer as tt
    for mod in (tl, ta, tt):
        mod.COMPUTE_DTYPE = torch.float32


@contextlib.contextmanager
def _recording(hops):
    """Within the block, each compressed hop (``_ag_impl`` and ``_rs_impl``
    of the port's collectives) appends ``(kind, dim, input, output)`` to
    ``hops``."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.codecs import TacoCodec
    impls = {name: getattr(cc, name) for name in ("_ag_impl", "_rs_impl")}
    for name, impl in impls.items():
        def rec(x, group, dim, codec, _impl=impl, _kind=name[1:3]):
            out = _impl(x, group, dim, codec)
            if isinstance(codec, TacoCodec):
                hops.append((_kind, dim, x.detach().numpy().copy(),
                             out.detach().numpy().copy()))
            return out
        setattr(cc, name, rec)
    try:
        yield
    finally:
        for name, impl in impls.items():
            setattr(cc, name, impl)


def _train_f32(rank, p, group, pl):
    """Every rank: loss and grads of one step per spec, in f32, with the
    ring's compressed hops recorded (key ``"hops"``); then the ring again
    with the plain rotation as an f32 matmul (key ``"f32 rotation"``)."""
    from repro_torch.core import ash
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    _f32()
    batch = {k: torch.from_numpy(v) for k, v in pl["batch"].items()}
    model = _port_model(p, rank)
    out = {"hops": []}
    for key, spec in (*zip(SPECS, SPECS), ("f32 rotation", RING_SPEC)):
        if key == "f32 rotation":
            ash._rotate = lambda z, h: z @ h
        ctx = ParallelCtx(plan=from_spec(spec), group=group)
        with (_recording(out["hops"]) if key == RING_SPEC
              else contextlib.nullcontext()):
            out[key] = _loss_grads(model, model.from_jax_params(pl["tree"]),
                                   batch, ctx)
    return out


def _inputs(p: int) -> dict:
    """The global f32 weights and the batch of :func:`jax_reference` at tp
    = ``p``: the JAX package's seeded init needs no device of its own, so
    this process draws the same bits."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, make_plan, smoke_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.model import Model
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = Model(cfg, make_plan(cfg, p, 1)).init(jax.random.PRNGKey(0),
                                                   dtype=jnp.float32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    return {"tree": jax.device_get(params),
            "batch": {k: np.asarray(v) for k, v in batch.items()}}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def both(request, tmp_path_factory):
    """The JAX package's and the port's runs at tp = P, side by side
    (:func:`test_torch_dist.beside`) on the same inputs; the subprocess's
    draws must be this process's bit for bit."""
    import jax

    from test_torch_dist import beside
    p = request.param
    tmp = tmp_path_factory.mktemp(f"ref{p}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={p}")
    inputs = _inputs(p)
    nb = {k: v.astype(np.float32 if k == "mask" else np.int64)
          for k, v in inputs["batch"].items()}
    port, rc, log = beside(
        [sys.executable, __file__, str(p), str(tmp / "jax.pkl")], env,
        tmp / "jax.log", JAX_TIMEOUT_S,
        lambda: run_group(tmp, p, _train_f32, {"tree": inputs["tree"],
                                               "batch": nb}))
    assert rc == 0, log
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    for key, value in inputs.items():
        for a, b in zip(jax.tree_util.tree_leaves(ref[key]),
                        jax.tree_util.tree_leaves(value), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=key)
    return p, ref, port


@pytest.mark.parametrize("spec", SPECS)
def test_train_step_at_tp_p_matches_jax_at_tp_p(both, spec):
    p, ref, port = both
    loss_tol, grad_tol = BOUNDS[spec]
    jl_, jgrads = ref[spec]
    full = _reassemble(_port_model(p, 0),
                       [port[r][spec][2] for r in range(p)])
    assert [g.shape for g in full] == [g.shape for g in jgrads]
    for r in range(p):                    # every rank holds the same loss
        assert port[r][spec][0] == port[0][spec][0]
    loss = port[0][spec][0]
    assert abs(loss - jl_) / abs(jl_) < loss_tol, (loss, jl_)
    assert rel(_flat(full), _flat(jgrads)) < grad_tol


def _port_flat(p, port, key):
    return _flat(_reassemble(_port_model(p, 0),
                             [port[r][key][2] for r in range(p)]))


def test_the_ring_is_compressed_in_both(both):
    """The ring's gradients differ from the identity plan's in both
    packages by the codec's error, so the bounds above hold a codec that
    ran."""
    p, ref, port = both
    j = rel(_flat(ref[RING_SPEC][1]), _flat(ref["baseline"][1]))
    t = rel(_port_flat(p, port, RING_SPEC), _port_flat(p, port, "baseline"))
    assert 1e-2 < j < 7.5e-2 and 1e-2 < t < 7.5e-2


def test_the_rotations_last_bit_spreads_the_ring_grads(both):
    """The port's ring against itself with only the rounding of its
    rotation changed stays within the ring's bounds (its gradients spread
    by 1.6e-2 at P = 2 and 3.8e-2 at P = 4: see the module docstring)."""
    p, _, port = both
    a, b = port[0][RING_SPEC], port[0]["f32 rotation"]
    assert abs(a[0] - b[0]) / abs(a[0]) < BOUNDS[RING_SPEC][0]
    spread = rel(_port_flat(p, port, "f32 rotation"),
                 _port_flat(p, port, RING_SPEC))
    assert spread < BOUNDS[RING_SPEC][1]


def test_the_references_ring_and_monolithic_hop_spread_as_far(both):
    """The reference's own ring and monolithic hop, bit-identical hop by
    hop there, give one step's loss within the ring's loss bound and
    gradients within the ring's gradient bound: a tighter gradient bound
    would fail the reference against itself."""
    _, ref, _ = both
    (ring_loss, ring), (mono_loss, mono) = ref[RING_SPEC], ref[MONO_SPEC]
    assert abs(ring_loss - mono_loss) / abs(mono_loss) < BOUNDS[RING_SPEC][0]
    assert rel(_flat(ring), _flat(mono)) < BOUNDS[RING_SPEC][1]


def test_every_compressed_hop_of_the_step_matches_the_jax_codec(both):
    """Each compressed hop of the port's ring step (forward all-gathers and
    reduce-scatters, and their conjugates in the backward pass), on every
    rank, against the JAX codec on the same per-rank inputs (the reference
    holds its ring bit-identical to this monolithic hop): within
    :data:`HOP_BOUND`, relative."""
    p, _, port = both
    hops = [port[r]["hops"] for r in range(p)]
    assert len({len(h) for h in hops}) == 1 and len(hops[0]) >= 16
    codec = _jax_codec(MONO_SPEC.removeprefix("tp="))
    for k, (kind, dim, _, _) in enumerate(hops[0]):
        assert dim == 1 and all(h[k][:2] == (kind, dim) for h in hops)
        xs = [h[k][2] for h in hops]
        want = ([_jax_ag(xs, codec)] * p if kind == "ag"
                else _jax_rs(xs, codec))
        for r in range(p):
            err = rel(hops[r][k][3], want[r])
            assert err < HOP_BOUND, (k, kind, r, err)


if __name__ == "__main__":
    jax_reference(int(sys.argv[1]), sys.argv[2])
