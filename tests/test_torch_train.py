"""The port's Megatron-SP training step held against the JAX package at
smoke size (qwen2-0.5b cut to 2 layers, d 128, vocab 503; batch 2, seq
64; tp = 1): JAX parameters carried across with ``Model.from_jax_params``,
the same batches from the same seed, one train step under ``none`` and
under ``tp=taco``, and a 3-step ``Trainer`` trajectory with ``warmup=1``.

Tolerances, each against what the JAX package does to itself:
  * loss, relative: 1e-3.  The forward's bf16 rounding differs (XLA
    fuses elementwise chains in f32 and rounds once; PyTorch rounds each
    op); measured 1e-5 (none) and 3e-5 (taco).
  * gradients in the model's bf16, relative Frobenius error over all
    parameters as one vector: 2e-2 (none, measured 6e-3) and 5e-2 (taco,
    measured 4.1e-2).  A per-tensor bound is not meaningful here: JAX
    itself, with one layer-norm scale nudged by one bf16 ulp, moves
    single tensors' gradients by up to 2.3e-2 (none; a k-bias gradient
    that is a sum with heavy cancellation) and 8.5e-2 (taco: an input on
    a quantization boundary lands one e4m3 code — 2^-3 relative — apart,
    and the codes of every later hop follow).
  * gradients per tensor in f32: both packages' compute dtype set to f32
    for the test, so the only differences left are f32 summation orders.
    1e-4 under none (measured 1e-6); 5e-2 under taco (measured 2.6e-2:
    the quantizer still turns 1e-7 input differences into whole-code
    differences, each hop amplifying the last).
  * the 3-step taco trajectory with warmup=1, relative per step: 1e-3
    (measured below 1e-4).
"""
import dataclasses
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
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models.model import Model
from repro.optim import adamw as jadamw
from repro.train.train_step import build_train_step as jbuild
from repro_torch import configs as tconfigs
from repro_torch.core.parallel import ParallelCtx as TCtx
from repro_torch.core.registry import from_spec as tfrom_spec
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import Model as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.train import trainer as ttrainer
from repro_torch.train.train_step import build_train_step as tbuild
from test_torch_dist import one_thread  # noqa: F401  (autouse)

SEQ, BATCH = 64, 2
SPECS = {"baseline": 2e-2, "taco": 5e-2}
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)


@pytest.fixture
def rng(request):
    """This module's own generator: the session-wide ``rng`` fixture's
    draws, which other files see, do not depend on this file."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def setup(dtype=jnp.bfloat16):
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, 1, 1))
    params = model.init(jax.random.PRNGKey(0), dtype=dtype)
    tcfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-0.5b"))
    tmodel = TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg)
    tdata = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, SEQ, BATCH),
                              tcfg)
    return model, params, tmodel, data, tdata


def jax_grads(model, params, batch, spec, tp_mode="sp"):
    """Loss and grads of the JAX train step's loss_fn on a 1-device mesh."""
    ctx = ParallelCtx(plan=from_spec(spec), tp_mode=tp_mode)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    pspecs = model.partition_specs()

    def loss_fn(p, b):
        loss_sum, count, _ = model.loss_parts(p, b, ctx)
        return loss_sum / jnp.maximum(count, 1.0)
    f = jax.jit(shard_map(jax.value_and_grad(loss_fn), mesh=mesh,
                          in_specs=(pspecs, model.batch_pspecs()),
                          out_specs=(P(), pspecs), check_vma=False))
    loss, grads = f(params, batch)
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree_util.tree_leaves(grads)]


def port_grads(tmodel, tparams, batch, spec, tp_mode="sp"):
    ctx = TCtx(plan=tfrom_spec(spec), tp_mode=tp_mode)
    flat = tadamw.leaves(tparams)
    for p in flat:
        p.requires_grad_(True)
    loss_sum, count, _ = tmodel.loss_parts(tparams, batch, ctx)
    loss = loss_sum / count.clamp_min(1.0)
    loss.backward()
    return float(loss.detach()), [p.grad.float().numpy() for p in flat]


def test_data_pipeline_is_the_reference_stream():
    cfg = smoke_config(get_config("qwen2-0.5b"))
    for step in (0, 5):
        a = SyntheticLM(DataConfig(cfg.vocab_size, 16, 3, seed=7),
                        cfg).batch(step)
        b = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, 16, 3,
                                               seed=7)).batch(step)
        for k in ("tokens", "labels", "mask"):
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_train_step_matches_jax(spec):
    """One full step of both packages' ``build_train_step`` (loss, grad
    norm, lr), and the bf16 gradients against JAX's."""
    model, params, tmodel, data, tdata = setup()
    batch, tbatch = data.batch(0), tdata.batch(0)
    jl, jg = jax_grads(model, params, batch, spec)
    tl, tg = port_grads(tmodel, tmodel.from_jax_params(
        jax.device_get(params)), tbatch, spec)
    assert abs(tl - jl) / jl < 1e-3
    assert rel(np.concatenate([g.ravel() for g in jg]),
               np.concatenate([g.ravel() for g in tg])) < SPECS[spec]

    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jstep = jbuild(model, mesh, ParallelCtx(plan=from_spec(spec)),
                   jadamw.OptConfig(**OPT), donate=False)
    _, jopt, jm = jstep(params, jadamw.init_opt_state(params), batch)
    tparams = tmodel.from_jax_params(jax.device_get(params))
    tstep = tbuild(tmodel, TCtx(plan=tfrom_spec(spec)),
                   tadamw.OptConfig(**OPT))
    topt = tadamw.init_opt_state(tparams)
    tparams, topt, tm = tstep(tparams, topt, tbatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) / float(jm["loss"]) \
        < 1e-3
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        / float(jm["grad_norm"]) < SPECS[spec]
    assert tm["lr"] == float(jm["lr"]) and topt["step"] == int(jopt["step"])
    assert all(p.grad is None and p.dtype == torch.bfloat16
               for p in tadamw.leaves(tparams))


def test_allreduce_tp_mode_matches_jax():
    """The training forward's other TP mode (f/g pairs around each block,
    the replicated residual): loss and bf16 gradients under taco, at the
    bounds above."""
    model, params, tmodel, data, tdata = setup()
    jl, jg = jax_grads(model, params, data.batch(0), "taco", "allreduce")
    tl, tg = port_grads(tmodel, tmodel.from_jax_params(
        jax.device_get(params)), tdata.batch(0), "taco", "allreduce")
    assert abs(tl - jl) / jl < 1e-3
    assert rel(np.concatenate([g.ravel() for g in jg]),
               np.concatenate([g.ravel() for g in tg])) < SPECS["taco"]


@pytest.mark.parametrize("causal,window,seq,chunk", [
    (True, None, 64, 16), (False, None, 64, 16), (True, 16, 64, 16),
    (True, None, 1024, 512)])
def test_attention_core_matches_jax(causal, window, seq, chunk, rng):
    """The chunked online softmax across several q and kv chunks, the
    sliding window and the non-causal form; bf16 outputs of |x| < 4, so
    within two bf16 ulps (atol 2^-6) of JAX's."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    q, k, v = (rng.normal(size=(2, seq, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = jattn.attention_core(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, q_chunk=chunk, kv_chunk=chunk)
    got = tattn.attention_core(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window, q_chunk=chunk,
                               kv_chunk=chunk)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(want).max() < 4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -6)


def test_seq_slice_takes_the_ranks_shard():
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    assert ttransformer.seq_slice(x, TCtx(), 1) is x
    assert ttransformer.seq_slice(x, TCtx(tp_mode="allreduce"), 2) is x
    torch.testing.assert_close(
        ttransformer.seq_slice(x, TCtx(tp_size=2, tp_rank=1), 2), x[:, 4:])


@pytest.mark.parametrize("spec,tol", [("baseline", 1e-4), ("taco", 5e-2)])
def test_train_grads_per_tensor_in_f32(spec, tol, monkeypatch):
    import repro.models.attention as ja
    import repro.models.layers as jl
    import repro.models.transformer as jt
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    for mod in (jl, ja, jt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tl, ta, ttransformer):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    model, params, tmodel, data, tdata = setup(jnp.float32)
    jl_, jg = jax_grads(model, params, data.batch(0), spec)
    tl_, tg = port_grads(tmodel, tmodel.from_jax_params(
        jax.device_get(params)), tdata.batch(0), spec)
    assert abs(tl_ - jl_) / jl_ < 1e-5
    for a, b in zip(jg, tg):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        assert rel(a, b) < tol, (a.shape, rel(a, b))


def test_adamw_update_matches_jax(rng):
    """f32 update arithmetic on the same grads, three steps: grad norm,
    masters and moments within 1e-5 relative (the global norm sums ~2e5
    squares in another order than XLA, which moves the clip scale and so
    every update by ~1e-6; atol 1e-8 is 1e-5 of one step's size, lr 1e-3,
    for masters that sit near 0); the bf16 parameters are the masters'
    cast."""
    model, params, tmodel, _, _ = setup()
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 0.1, p.shape), jnp.bfloat16),
        params)
    oc = jadamw.OptConfig(**OPT)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    pspecs = model.partition_specs()
    ospecs = jadamw.opt_state_pspecs(pspecs)
    f = jax.jit(shard_map(
        lambda g, o: jadamw.adamw_update(g, o, oc, model)[1:], mesh=mesh,
        in_specs=(pspecs, ospecs), out_specs=(ospecs, {"grad_norm": P(),
                                                        "lr": P()}),
        check_vma=False))
    jopt = jadamw.init_opt_state(params)
    tparams = tmodel.from_jax_params(jax.device_get(params))
    topt = tadamw.init_opt_state(tparams)
    tgrads = tmodel.from_jax_params(jax.device_get(grads))
    for _ in range(3):
        jopt, jm = f(grads, jopt)
        tm = tadamw.adamw_update(tparams, tgrads, topt, tadamw.OptConfig(
            **OPT), tmodel)
        assert tm["lr"] == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            < 1e-5 * float(jm["grad_norm"])
    for key in ("master", "mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jopt[key])),
                        tadamw.leaves(topt[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-8)
    for m, p in zip(tadamw.leaves(topt["master"]), tadamw.leaves(tparams)):
        assert torch.equal(p, m.to(torch.bfloat16))


def test_trainer_trajectory_matches_jax(tmp_path):
    from repro.train.trainer import Trainer, TrainerConfig
    spec = "tp=taco,warmup=1"
    model, params, tmodel, data, tdata = setup()
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jtr = Trainer(model, mesh, ParallelCtx(plan=from_spec(spec)),
                  jadamw.OptConfig(**OPT),
                  TrainerConfig(total_steps=3, ckpt_every=100, log_every=100,
                                ckpt_dir=str(tmp_path)), data)
    _, _, jlosses = jtr.run(resume=False)
    ttr = ttrainer.Trainer(tmodel, TCtx(plan=tfrom_spec(spec)),
                           tadamw.OptConfig(**OPT),
                           ttrainer.TrainerConfig(total_steps=3), tdata)
    _, _, hist = ttr.run(params=tmodel.from_jax_params(
        jax.device_get(params)))
    assert [h["plan"] for h in hist] == ["baseline", "tp=taco", "tp=taco"]
    assert len(jlosses) == 3
    for a, b in zip(jlosses, ttr.losses):
        assert abs(a - b) / a < 1e-3, (jlosses, ttr.losses)


# --------------------------------------------------------------------------
# the hop count per step, and the entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("spec", ["taco", "tp_fwd=taco",
                                  "tp=taco,skip_first=1"])
@pytest.mark.parametrize("budget", [None, 0], ids=["wire", "blocks"])
def test_hops_per_step_are_the_derived_count(remat, spec, budget,
                                             monkeypatch):
    """Operator calls of one train step (the launch counts that
    chip_smoke.py checks on the card) equal ``tp_hops_per_step``."""
    if budget is not None:
        monkeypatch.setattr(ops, "WIRE_FUSED_MAX_SLOT_ELEMS", budget)
    calls = {}
    for name in ("compress_blocks", "decompress_blocks", "decompress_reduce",
                 "compress_wire", "decompress_wire", "decompress_reduce_wire"):
        def spy(*a, _inner=getattr(ops, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _inner(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    cfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-0.5b"))
    plan = tconfigs.make_plan(cfg, 1, 1, remat=remat)
    model = TModel(cfg, plan, device="cpu")
    comm = tfrom_spec(spec)
    data = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, 32, 2))
    step = tbuild(model, TCtx(plan=comm), tadamw.OptConfig(**OPT))
    params = model.init(0)
    step(params, tadamw.init_opt_state(params), data.batch(0))
    hops = ttransformer.tp_hops_per_step(cfg, plan, comm)
    form = ("compress_blocks", "decompress_blocks", "decompress_reduce") \
        if budget == 0 else ("compress_wire", "decompress_wire",
                             "decompress_reduce_wire")
    want = {form[0]: hops["all_gather"] + hops["reduce_scatter"],
            form[1]: hops["all_gather"], form[2]: hops["reduce_scatter"]}
    assert calls == want
    if spec == "taco":
        layers = cfg.n_layers
        assert hops == ({"all_gather": 6 * layers + 2,
                         "reduce_scatter": 5 * layers + 2,
                         "all_to_all": 0, "permute": 0} if remat else
                        {"all_gather": 4 * layers + 2,
                         "reduce_scatter": 4 * layers + 2,
                         "all_to_all": 0, "permute": 0})


def test_train_launcher_on_cpu_and_without_a_card(capsys, monkeypatch):
    from repro_torch.launch import train
    train.main(["--device", "cpu", "--steps", "2", "--seq", "32",
                "--batch", "2", "--comm-spec", "tp=taco,warmup=1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("step 0 loss") and "plan baseline" in out[0]
    assert "plan tp=taco" in out[1]
    assert out[-1].startswith("qwen2-0.5b-smoke: loss")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


def test_trainer_refuses_what_the_slice_lacks():
    """Checkpoints and fault injection are ported (``ckpt_dir``,
    ``injector``: tests/test_torch_checkpoint.py), and so are the policy
    controllers (tests/test_torch_policy.py): both specs below parse and
    train.  ``remat_policy='dots'`` is ported: it trains, and its loss is
    full recompute's (tests/test_torch_encdec.py holds its grads).
    ``escalate=`` needs a registered fallback and a threshold:
    ``escalate=sdp4bit`` is refused as the JAX registry refuses it."""
    cfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-0.5b"))
    model = TModel(cfg, tconfigs.make_plan(cfg, 1, 1), device="cpu")
    data = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, 32, 2))
    plan = dataclasses.replace(tconfigs.make_plan(cfg, 1, 1),
                               remat_policy="dots")
    losses = {}
    for m in (model, TModel(cfg, plan, device="cpu")):
        tr = ttrainer.Trainer(m, TCtx(), tadamw.OptConfig(**OPT),
                              ttrainer.TrainerConfig(total_steps=2), data)
        tr.run()
        losses[m.plan.remat_policy] = tr.losses
    assert losses["dots"] == losses["full"]
    assert len(losses["dots"]) == 2 and np.isfinite(losses["dots"]).all()
    from repro.core.registry import CommSpecError as JCommSpecError
    from repro_torch.core.registry import CommSpecError
    for bad in ("tp=taco:escalate=sdp4bit", "tp=taco:escalate=sdp4bit@0.1"):
        with pytest.raises(JCommSpecError):
            from_spec(bad)
        with pytest.raises(CommSpecError, match="escalat"):
            tfrom_spec(bad)
    for spec in ("tp=taco:escalate=bf16@0.08", "tp=taco+zle:slot=auto"):
        tr = ttrainer.Trainer(model, TCtx(plan=tfrom_spec(spec)),
                              tadamw.OptConfig(**OPT),
                              ttrainer.TrainerConfig(total_steps=2), data)
        hist = tr.run()[2]
        assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
        assert tr.policy.controllers


def test_warmup_schedule_matches_jax():
    for spec in ("tp=taco,warmup=3", "tp=taco:folded,skip_first=1,warmup=2",
                 "taco"):
        jp, tp = from_spec(spec), tfrom_spec(spec)
        from repro.core.registry import to_spec as jto
        from repro_torch.core.registry import to_spec as tto
        for step in range(5):
            assert tto(tp.at_step(step)) == jto(jp.at_step(step))
        assert tto(tp.steady()) == jto(jp.steady())
