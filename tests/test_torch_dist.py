"""The port across processes: tensor parallelism over a gloo group of P = 2
and 4 ranks on the CPU, held against the JAX package and against the
port's own one-process runs.

Each group is P spawned processes sharing a ``FileStore`` under the test's
``tmp_path``; its collectives time out after 60 s and the whole group
after 240 s, so a hang fails and does not stall the suite.  The ranks
import torch and the port only; the JAX references run here, in the test
process, on the same numpy inputs.

What is held, and to what:
  * collectives (f32 inputs, per-rank inputs from a seeded numpy
    generator): ``all_gather_c``, ``psum_scatter_c`` and ``allreduce_g``
    under ``taco`` and ``taco:folded`` on every rank, against the JAX
    codec on the same per-peer inputs — ``encode_wire`` per peer, stack,
    ``decode_wire`` / ``decode_sum_wire``, which is what the JAX
    ``_transport`` does on one rank — within the ``tests/test_kernels.py``
    decode tolerance (rtol 1e-4, atol 1e-5), on both codec routes (the
    wire kernels' and the block kernels').  The chunked ring (``chunks``
    2 and 4, ``schedule`` pipelined and serial) equals the port's
    monolithic hop bit for bit on every rank.  The identity codec equals
    the plain numpy concatenation / sum (rtol 1e-6: gloo's summation
    order).  Autograd: the backward of ``all_gather_c`` is
    ``psum_scatter_c`` of the cotangent with the codecs swapped, and back,
    bit for bit.
  * training (smoke qwen2-0.5b: 2 layers, d 128, vocab 503, batch 2 x seq
    64, full recompute): the loss and grads of one step from the JAX
    package's global parameters for the tp = P plan, sliced per rank by
    ``Model.from_jax_params``.  Against the JAX package's single-device
    run (the contract of ``tests/multidev/check_tp_model.py``): the
    identity plan's loss within 2e-2 and grad norm within 5e-2 relative;
    ``tp=taco:folded:chunks=4``'s loss within 5e-2 of the JAX baseline.
    Against the port's own tp = 1 run from the same global parameters
    (the padded shapes agree at smoke size), with the grads reassembled
    from the shards: loss within 1e-3 and all-parameter grads within 2e-2
    relative under the identity plan (bf16 partial sums are added in
    another order: contraction order).  Under ``tp=taco:folded:chunks=4``
    the loss within 1e-3 (the taco loss bound of
    ``tests/test_torch_train.py``); its grads quantize
    per-rank partial sums where tp = 1 quantizes the whole sum, so they
    are held by the codec's error against the identity plan (see the
    test's docstring).
    The launcher's ``Trainer`` gives every rank the same losses.  At
    tp = 4 a 14-head / 2-kv-head variant pads its q heads to 16; its
    loss and grad norm are held to the same contract.
  * serving (P = 2): greedy tokens of teacher-forced decode equal tp = 1's
    under the identity plan, with the gathered logits within the identity
    bound of ``tests/test_torch_model.py`` (2e-2 relative); under ``taco``
    the codec's error is held as for the grads (see the test).  The
    engine serves the same requests with the same tokens on every rank.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import queue
import time
import traceback

import numpy as np
import pytest
import torch

from conftest import tp_like


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module on one intra-op thread, as each rank of a group runs
    (``_worker``), and so each module that imports this fixture: under the
    suite's parallel workers torch's default of one thread a core
    oversubscribes the machine and small steps crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GROUP_TIMEOUT_S = 240
COLL_TIMEOUT_S = 60
SEQ, BATCH = 64, 2
SPECS_MONO = ("taco", "taco:folded")
RING = [f"taco:folded:chunks={c}{s}" for c in (2, 4)
        for s in ("", ":schedule=serial")] + ["taco:chunks=4"]
RING_SPEC = "tp=taco:folded:chunks=4"
PADDED = dict(n_heads=14, n_kv_heads=2, d_model=224)


# --------------------------------------------------------------------------
# the group: P spawned ranks over a FileStore
# --------------------------------------------------------------------------

def _worker(rank, p, store, task, payload, out):
    try:
        torch.set_num_threads(1)
        from repro_torch.core.parallel import init_tp_group
        import torch.distributed as dist
        group = init_tp_group("cpu", init_method=f"file://{store}",
                              world_size=p, rank=rank,
                              timeout_s=COLL_TIMEOUT_S)
        res = (TASKS[task] if isinstance(task, str) else task)(
            rank, p, group, payload)
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, res, None))
    except Exception:                # the parent raises it with the trace
        out.put((rank, None, traceback.format_exc()))


def run_group(tmp_path, p, task, payload):
    """Run ``TASKS[task](rank, p, group, payload)`` on each of ``p`` ranks
    (or ``task`` itself, a module-level function of a test module);
    returns the results by rank."""
    mp = multiprocessing.get_context("spawn")
    out = mp.Queue()
    name = task if isinstance(task, str) else task.__name__
    store = tmp_path / f"store-{name}-{p}"
    procs = [mp.Process(target=_worker,
                        args=(r, p, str(store), task, payload, out))
             for r in range(p)]
    for pr in procs:
        pr.start()
    results, deadline = {}, time.monotonic() + GROUP_TIMEOUT_S
    try:
        while len(results) < p:
            try:
                rank, res, err = out.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(f"{name} on {p} ranks: no result "
                                     f"within {GROUP_TIMEOUT_S}s") from None
            if err is not None:
                raise AssertionError(f"rank {rank} of {p}:\n{err}")
            results[rank] = res
    finally:
        for pr in procs:
            pr.join(timeout=10)
            if pr.is_alive():
                pr.terminate()
    return [results[r] for r in range(p)]


def beside(args, env, log_path, timeout, fn):
    """Run ``fn()`` in this process while the command ``args`` runs (the
    JAX package on forced host devices, say), so that their times
    overlap.  Returns ``(fn's result, the command's exit code, the tail
    of its output)``; the command's output goes to ``log_path`` (a pipe
    nobody reads while ``fn`` runs could fill and stall it), and it is
    killed if ``fn`` raises or it outlives ``timeout``."""
    import subprocess
    with open(log_path, "w") as log, subprocess.Popen(
            args, env=env, stdout=log, stderr=subprocess.STDOUT) as proc:
        try:
            out = fn()
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
    with open(log_path) as log:
        return out, proc.returncode, log.read()[-4000:]


# --------------------------------------------------------------------------
# tasks run by every rank
# --------------------------------------------------------------------------

def _collectives(rank, p, group, pl):
    from repro_torch.core import collectives as cc
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ops
    t = {k: torch.from_numpy(v[rank]) for k, v in pl.items()}
    res = {}
    for budget in (None, 0):
        if budget is not None:
            ops.WIRE_FUSED_MAX_SLOT_ELEMS = budget
        for spec in SPECS_MONO + tuple(RING):
            c = codec_from_spec(spec)
            res[(budget, spec)] = {
                "ag": cc.all_gather_c(t["ag"], group, 1, c, c).numpy(),
                "rs": cc.psum_scatter_c(t["rs"], group, 1, c, c).numpy(),
                "ar": cc.allreduce_g(t["ar"], group, c, c).numpy()}
    ops.WIRE_FUSED_MAX_SLOT_ELEMS = 512 * 1024
    ident = codec_from_spec("none")
    res["none"] = {
        "ag": cc.all_gather_c(t["ag"], group, 1, ident, ident).numpy(),
        "rs": cc.psum_scatter_c(t["rs"], group, 1, ident, ident).numpy(),
        "ar": cc.allreduce_g(t["ar"], group, ident, ident).numpy(),
        "psum": cc.psum_exact(t["ar"][0, 0], group).numpy(),
        "pmax": cc.pmax(t["ar"][0], group).numpy()}
    # autograd: each pair's backward is its conjugate on the cotangent
    fc, bc = codec_from_spec("taco:folded:chunks=2"), codec_from_spec("taco")
    grads = {}
    for name, fwd, conj, x, ct in (
            ("ag", cc.all_gather_c, cc.psum_scatter_c, t["ag"], t["rs"]),
            ("rs", cc.psum_scatter_c, cc.all_gather_c, t["rs"], t["ag"])):
        xx = x.clone().requires_grad_(True)
        fwd(xx, group, 1, fc, bc).backward(ct)
        grads[name] = (xx.grad.numpy(), conj(ct, group, 1, bc, fc).numpy())
    res["grads"] = grads
    return res


def _loss_grads(model, params, batch, ctx):
    from repro_torch.optim import adamw
    flat = adamw.leaves(params)
    for q in flat:
        q.requires_grad_(True)
    loss_sum, count, _ = model.loss_parts(params, batch, ctx)
    loss = loss_sum / count.clamp_min(1.0)
    loss.backward()
    grads = adamw.finalize_grads(adamw.tree_map(
        lambda q: torch.zeros_like(q) if q.grad is None else q.grad, params),
        model, ctx.comm)
    gnorm = adamw.global_grad_norm(grads, model, ctx.comm)
    return (float(loss.detach()), float(gnorm),
            [g.float().numpy() for g in adamw.leaves(grads)])


def _port_model(p, rank, override=None, remat=True):
    from repro_torch import configs
    from repro_torch.models.model import Model
    cfg = configs.smoke_config(configs.get_config("qwen2-0.5b"))
    if override:
        cfg = dataclasses.replace(cfg, **override)
    return Model(cfg, configs.make_plan(cfg, p, 1, remat=remat),
                 device="cpu", tp_rank=rank)


def _train(rank, p, group, pl):
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.launch import train
    batch = {k: torch.from_numpy(v) for k, v in pl["batch"].items()}
    res = {}
    for name, (override, tree, specs) in pl["runs"].items():
        model = _port_model(p, rank, override)
        for spec in specs:
            ctx = ParallelCtx(plan=from_spec(spec), group=group)
            res[(name, spec)] = _loss_grads(
                model, model.from_jax_params(tree), batch, ctx)
    args = train.parse_args([
        "--device", "cpu", "--smoke", "--mesh", f"1,1,{p}", "--steps", "2",
        "--seq", "32", "--batch", "2", "--comm-spec", RING_SPEC])
    trainer, _ = train.build_trainer(args, group=group)
    res["trainer"] = [h["loss"] for h in trainer.run()[2]]
    return res


def _serve(rank, p, group, pl):
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.launch import serve
    from repro_torch.serve import serve_step as ss
    model = _port_model(p, rank, remat=False)
    params = model.from_jax_params(pl["tree"])
    toks = torch.from_numpy(pl["tokens"])
    res = {}
    for spec in ("baseline", "taco"):
        ctx = ParallelCtx(plan=from_spec(spec), group=group)
        cache = ss.init_cache(model, toks.shape[0], 16)
        steps = []
        for i in range(toks.shape[1]):
            nxt, logits = ss.decode_forward(params, toks[:, i:i + 1], cache,
                                            i, model, ctx, return_logits=True)
            steps.append((nxt.numpy(), logits.numpy()))
        res[spec] = steps
    args = serve.parse_args([
        "--device", "cpu", "--mesh", f"1,1,{p}", "--requests", "3",
        "--prompt-len", "4", "--gen", "5", "--max-batch", "2", "--qps",
        "200", "--comm-spec", RING_SPEC])
    eng, cfg = serve.build_engine(args, group=group)
    summary, _ = serve.drive(eng, args, cfg)
    res["engine"] = (summary["requests"],
                     sorted(r.tokens for r in eng.sched.done))
    return res


TASKS = {"collectives": _collectives, "train": _train, "serve": _serve}


def _tasks(rank, p, group, pl):
    """Every task named in ``pl`` (name -> its payload) in turn, on one
    group."""
    return {name: TASKS[name](rank, p, group, payload)
            for name, payload in pl.items()}


# --------------------------------------------------------------------------
# references in this process
# --------------------------------------------------------------------------

def _jax_codec(spec):
    from repro.core.registry import codec_from_spec as jspec
    return jspec(spec.replace("taco", "taco:jnp", 1))


def _pad(a, mult):
    rem = (-a.shape[-1]) % mult
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, rem)]), a.shape[-1]


def _jax_ag(xs, codec):
    """Every rank's all-gather along dim 1 of the per-peer inputs ``xs``."""
    import jax.numpy as jnp
    p = len(xs)
    rows = [_pad(x.reshape(1, -1), codec.granule) for x in xs]
    pn = rows[0][0].shape[-1]
    wire = jnp.concatenate([codec.encode_wire(jnp.asarray(r)) for r, _ in rows])
    dec = np.asarray(codec.decode_wire(wire, pn, jnp.float32))[:, :rows[0][1]]
    return np.concatenate(list(dec.reshape(p, *xs[0].shape)), axis=1)


def _jax_rs(xs, codec):
    """Every rank's reduce-scatter along dim 1: per rank r, the stack of
    peer j's row r, then the fused decode_sum."""
    import jax.numpy as jnp
    p = len(xs)
    rows = [_pad(np.moveaxis(x, 1, 0).reshape(p, -1), codec.granule)
            for x in xs]
    pn, n = rows[0][0].shape[-1], rows[0][1]
    wires = [np.asarray(codec.encode_wire(jnp.asarray(r))) for r, _ in rows]
    out = []
    shape = np.moveaxis(xs[0], 1, 0).shape
    for r in range(p):
        stack = jnp.asarray(np.stack([w[r] for w in wires]))
        s = np.asarray(codec.decode_sum_wire(stack, pn, jnp.float32))[:n]
        out.append(np.moveaxis(s.reshape(shape[0] // p, *shape[1:]), 0, 1))
    return out


def _jax_ar(xs, codec):
    p = len(xs)
    flats = [_pad(x.reshape(1, -1), p * codec.granule)[0] for x in xs]
    pieces = _jax_rs([f.reshape(1, p, -1) for f in flats], codec)
    full = _jax_ag([q.reshape(1, -1) for q in pieces], codec)
    return full.reshape(-1)[:xs[0].size].reshape(xs[0].shape)


def _inputs(p):
    gen = np.random.default_rng(1000 + p)
    return {"ag": np.stack([tp_like(gen, (2, 4, 96)) for _ in range(p)]),
            "rs": np.stack([tp_like(gen, (2, 4 * p, 96)) for _ in range(p)]),
            "ar": np.stack([tp_like(gen, (3, 100)) for _ in range(p)])}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world of each size for the module, its ranks running the
    collectives and the training tasks (P = 2 and 4) and the serving task
    (P = 2) in turn: a world starts once, and each payload is made once.
    Returns by P the payload, the training task's JAX references
    (:func:`_train_payload`) and the results, a list by rank of {task:
    result}."""
    out = {}
    for p in (2, 4):
        train, train_ref = _train_payload(p)
        payload = {"collectives": _inputs(p), "train": train}
        if p == 2:
            payload["serve"] = _serve_payload()
        out[p] = {"payload": payload, "train_ref": train_ref,
                  "ranks": run_group(tmp_path_factory.mktemp(f"world{p}"),
                                     p, _tasks, payload)}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def collectives(request, worlds):
    p = request.param
    w = worlds[p]
    return (p, w["payload"]["collectives"],
            [r["collectives"] for r in w["ranks"]])


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 0], ids=["wire", "blocks"])
@pytest.mark.parametrize("spec", SPECS_MONO)
def test_collectives_match_the_jax_codec(collectives, spec, budget):
    p, xs, res = collectives
    codec = _jax_codec(spec)
    want = {"ag": [_jax_ag(list(xs["ag"]), codec)] * p,
            "rs": _jax_rs(list(xs["rs"]), codec),
            "ar": [_jax_ar(list(xs["ar"]), codec)] * p}
    for r in range(p):
        for hop in ("ag", "rs", "ar"):
            np.testing.assert_allclose(res[r][(budget, spec)][hop],
                                       want[hop][r], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{hop} rank {r}")


@pytest.mark.parametrize("budget", [None, 0], ids=["wire", "blocks"])
@pytest.mark.parametrize("spec", RING)
def test_ring_is_bit_identical_to_the_monolithic_hop(collectives, spec,
                                                     budget):
    p, _, res = collectives
    for r in range(p):
        for hop in ("ag", "rs", "ar"):
            np.testing.assert_array_equal(
                res[r][(budget, spec)][hop],
                res[r][(budget, spec.split(":chunks")[0])][hop],
                err_msg=f"{spec} {hop} rank {r}")


def test_identity_codec_is_the_plain_collective(collectives):
    p, xs, res = collectives
    ag = np.concatenate(list(xs["ag"]), axis=1)
    total = xs["rs"].sum(axis=0)
    for r in range(p):
        got = res[r]["none"]
        np.testing.assert_array_equal(got["ag"], ag)
        np.testing.assert_allclose(got["rs"],
                                   total[:, 4 * r:4 * (r + 1)], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got["ar"], xs["ar"].sum(axis=0),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["psum"], xs["ar"][:, 0, 0].sum(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["pmax"], xs["ar"][:, 0].max(0))


def test_backward_is_the_conjugate_collective(collectives):
    p, _, res = collectives
    for r in range(p):
        for name, (grad, conj) in res[r]["grads"].items():
            np.testing.assert_array_equal(grad, conj, err_msg=name)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _jax_setup(p, override=None, plan_tp=None):
    import jax
    from repro.configs import get_config, make_plan, smoke_config
    from repro.models.model import Model
    cfg = smoke_config(get_config("qwen2-0.5b"))
    if override:
        cfg = dataclasses.replace(cfg, **override)
    model = Model(cfg, make_plan(cfg, plan_tp or p, 1))
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


def _jax_loss_gnorm(cfg, params, batch, spec="baseline"):
    """Loss and global grad norm of the JAX package's single-device run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.configs import make_plan
    from repro.core.parallel import ParallelCtx
    from repro.core.registry import from_spec
    from repro.models.model import Model
    model = Model(cfg, make_plan(cfg, 1, 1))
    ctx = ParallelCtx(plan=from_spec(spec))
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    pspecs = model.partition_specs()

    def loss_fn(q, b):
        loss_sum, count, _ = model.loss_parts(q, b, ctx)
        return loss_sum / jnp.maximum(count, 1.0)
    f = jax.jit(shard_map(jax.value_and_grad(loss_fn), mesh=mesh,
                          in_specs=(pspecs, model.batch_pspecs()),
                          out_specs=(P(), pspecs), check_vma=False))
    loss, grads = f(params, batch)
    sq = sum(float(np.sum(np.asarray(g, np.float32) ** 2))
             for g in jax.tree_util.tree_leaves(grads))
    return float(loss), float(np.sqrt(sq))


def _pad_heads(tree, cfg, heads_pad):
    """The tp = 1 global weights of ``cfg`` with dead q heads appended up
    to ``heads_pad`` (random weights: their output is masked)."""
    gen = np.random.default_rng(7)
    extra = (heads_pad - cfg.n_heads) * cfg.hd
    attn = dict(tree["segments"][0]["attn"])
    wq, wo = np.asarray(attn["wq"]), np.asarray(attn["wo"])
    attn["wq"] = np.concatenate(
        [wq, gen.normal(0, 0.02, wq.shape[:2] + (extra,)).astype(wq.dtype)],
        axis=2)
    attn["wo"] = np.concatenate(
        [wo, gen.normal(0, 0.02, (wo.shape[0], extra, wo.shape[2]))
         .astype(wo.dtype)], axis=1)
    if "bq" in attn:
        bq = np.asarray(attn["bq"])
        attn["bq"] = np.concatenate(
            [bq, np.zeros(bq.shape[:1] + (extra,), bq.dtype)], axis=1)
    seg = dict(tree["segments"][0], attn=attn)
    return dict(tree, segments=[seg])


def _train_payload(p):
    """(the training task's payload at tp = ``p``, the JAX references the
    tests hold it to: the batch, the global weights and the JAX params)."""
    import jax
    from repro.data.pipeline import DataConfig, SyntheticLM
    cfg, _, params = _jax_setup(p)
    tree = jax.device_get(params)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg).batch(0)
    nb = {k: np.asarray(v).astype(np.int64 if k != "mask" else np.float32)
          for k, v in batch.items()}
    runs = {"smoke": (None, tree, ("baseline", RING_SPEC))}
    ref = {"smoke": (cfg, params)}
    if p == 4:
        pcfg, _, pparams = _jax_setup(1, PADDED, plan_tp=1)
        from repro.configs import make_plan
        heads_pad = make_plan(pcfg, 4, 1).heads_pad
        assert heads_pad == 16 != pcfg.n_heads
        runs["padded"] = (PADDED, _pad_heads(jax.device_get(pparams), pcfg,
                                             heads_pad), ("baseline",))
        ref["padded"] = (pcfg, pparams)
    return {"batch": nb, "runs": runs}, (nb, tree, ref, batch)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def trained(request, worlds):
    p = request.param
    nb, tree, ref, batch = worlds[p]["train_ref"]
    return p, nb, tree, ref, batch, [r["train"] for r in worlds[p]["ranks"]]


def _reassemble(model, shards):
    """Global grads from per-rank shard grads (replicated ones are equal
    on every rank after ``finalize_grads``)."""
    from repro_torch.optim import adamw
    out = []
    for i, spec in enumerate(adamw.leaves(model.specs())):
        parts = [s[i] for s in shards]
        out.append(parts[0] if spec.tp_dim is None
                   else np.concatenate(parts, axis=spec.tp_dim))
    return out


def test_ranks_agree_on_the_loss_and_the_grad_norm(trained):
    p, _, _, _, _, res = trained
    for key in res[0]:
        if key == "trainer":
            continue
        for r in range(1, p):
            assert res[r][key][:2] == res[0][key][:2], key
    for r in range(1, p):
        assert res[r]["trainer"] == res[0]["trainer"]
    assert all(np.isfinite(res[0]["trainer"]))


@pytest.mark.parametrize("spec,loss_tol", [("baseline", 2e-2),
                                           (RING_SPEC, 5e-2)])
def test_train_step_matches_jax_single_device(trained, spec, loss_tol):
    p, _, _, ref, batch, res = trained
    cfg, params = ref["smoke"]
    jl, jg = _jax_loss_gnorm(cfg, params, batch)
    loss, gnorm, _ = res[0][("smoke", spec)]
    assert abs(loss - jl) / jl < loss_tol
    if spec == "baseline":
        assert abs(gnorm - jg) / jg < 5e-2
        if p == 4:
            pcfg, pparams = ref["padded"]
            pl_, pg = _jax_loss_gnorm(pcfg, pparams, batch)
            loss, gnorm, _ = res[0][("padded", "baseline")]
            assert abs(loss - pl_) / pl_ < 2e-2
            assert abs(gnorm - pg) / pg < 5e-2


def _port_tp1(tree, nb, spec):
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    model = _port_model(1, 0)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    return _loss_grads(model, model.from_jax_params(tree), batch,
                       ParallelCtx(plan=from_spec(spec)))


def _flat(grads):
    return np.concatenate([g.ravel() for g in grads])


def test_identity_train_step_matches_the_ports_tp1(trained):
    p, nb, tree, _, _, res = trained
    l1, _, grads1 = _port_tp1(tree, nb, "baseline")
    loss, _, shards = res[0][("smoke", "baseline")]
    full = _reassemble(_port_model(p, 0),
                       [res[r][("smoke", "baseline")][2] for r in range(p)])
    assert [g.shape for g in full] == [g.shape for g in grads1]
    assert abs(loss - l1) / l1 < 1e-3
    assert rel(_flat(full), _flat(grads1)) < 2e-2


def test_compressed_train_step_matches_the_ports_tp1(trained):
    """The ring run at tp = P against the port's tp = 1 run: the loss
    within 1e-3.  The grads cannot be held to a parity bound: the two runs
    quantize different tensors (per-rank partial sums at tp = P, the whole
    sum at tp = 1), so their quantization errors are independent draws.
    Held instead: the codec's error against the identity plan is no larger
    at tp = P than the bound it meets at tp = 1 (7.5e-2; measured 5.6e-2 at
    both), and the two runs differ by at most the two independent errors
    added in quadrature (sqrt(2) x 7.5e-2 = 0.11; measured 6.1e-2 at P = 2
    and 7.3e-2 at P = 4)."""
    p, nb, tree, _, _, res = trained
    l1, _, taco1 = _port_tp1(tree, nb, RING_SPEC)
    _, _, base1 = _port_tp1(tree, nb, "baseline")
    full = {spec: _flat(_reassemble(_port_model(p, 0), [
        res[r][("smoke", spec)][2] for r in range(p)]))
        for spec in ("baseline", RING_SPEC)}
    assert abs(res[0][("smoke", RING_SPEC)][0] - l1) / l1 < 1e-3
    assert rel(_flat(taco1), _flat(base1)) < 7.5e-2
    assert rel(full[RING_SPEC], full["baseline"]) < 7.5e-2
    assert rel(full[RING_SPEC], _flat(taco1)) < 0.11


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _serve_payload():
    """The serving task's payload at tp = 2: the global weights and the
    teacher-forced tokens."""
    import jax
    from repro.configs import get_config, make_plan, smoke_config
    from repro.models.model import Model
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = Model(cfg, make_plan(cfg, 2, 1, remat=False)).init(
        jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (3, 6)).astype(np.int64)
    return {"tree": jax.device_get(params), "tokens": toks}


@pytest.fixture(scope="module")
def served(worlds):
    pl = worlds[2]["payload"]["serve"]
    return pl["tree"], pl["tokens"], [r["serve"] for r in worlds[2]["ranks"]]


def _tp1_decode(tree, toks, spec):
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.serve import serve_step as ss
    model = _port_model(1, 0, remat=False)
    params = model.from_jax_params(tree)
    ctx = ParallelCtx(plan=from_spec(spec))
    cache = ss.init_cache(model, toks.shape[0], 16)
    t = torch.from_numpy(toks)
    return [tuple(a.numpy() for a in ss.decode_forward(
        params, t[:, i:i + 1], cache, i, model, ctx, return_logits=True))
        for i in range(toks.shape[1])]


def test_identity_decode_at_tp2_matches_tp1(served):
    tree, toks, res = served
    for i, (nxt1, logits1) in enumerate(_tp1_decode(tree, toks, "baseline")):
        nxt = [res[r]["baseline"][i][0] for r in range(2)]
        np.testing.assert_array_equal(nxt[0], nxt[1])
        np.testing.assert_array_equal(nxt[0], nxt1)
        logits = np.concatenate([res[r]["baseline"][i][1] for r in range(2)],
                                axis=-1)
        assert rel(logits, logits1) < 2e-2


def test_compressed_decode_at_tp2_matches_tp1(served):
    """Under ``taco`` the two shards' partial sums are quantized at tp = 2
    where tp = 1 quantizes their sum, so the two runs' codec errors are
    independent draws: each run's logits are held within
    ``tests/test_torch_model.py``'s taco bound scaled to an error against
    the identity plan (7.5e-2; measured 3.8e-2 to 5.4e-2 at both tp), and
    the two runs within the two errors added in quadrature (0.11;
    measured 4.3e-2 to 5.1e-2)."""
    tree, toks, res = served
    base1 = _tp1_decode(tree, toks, "baseline")
    for i, (nxt1, logits1) in enumerate(_tp1_decode(tree, toks, "taco")):
        got = {spec: np.concatenate([res[r][spec][i][1] for r in range(2)],
                                    axis=-1) for spec in ("baseline", "taco")}
        np.testing.assert_array_equal(res[0]["taco"][i][0],
                                      res[1]["taco"][i][0])
        assert rel(logits1, base1[i][1]) < 7.5e-2
        assert rel(got["taco"], got["baseline"]) < 7.5e-2
        assert rel(got["taco"], logits1) < 0.11


def test_engine_serves_the_same_tokens_on_every_rank(served):
    _, _, res = served
    assert res[0]["engine"] == res[1]["engine"]
    n, tokens = res[0]["engine"]
    assert n == 3 and all(len(t) == 5 for t in tokens)
