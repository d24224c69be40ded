"""The port's checkpoints, restart and runtime held against the JAX
package, in one process on the CPU.

  * Twins of the green tests of ``tests/test_checkpoint.py`` on torch
    trees (f32, int32 and bf16 leaves): bit-exact round trip, keep-last-k,
    an interrupted save never visible, the latest step by default, the
    comm spec persisted and checked, spec-less checkpoints restored
    unchecked; and a mismatched template raises ``ValueError`` naming the
    first mismatching key.
  * Across packages, both ways, at smoke qwen2-0.5b (bf16 params; batch
    2 x seq 64, the shapes of ``tests/test_torch_train.py``): the JAX
    trainer saves after 2 steps and the port restores it, every leaf
    bitwise the JAX state cut to each rank at (tp, fsdp) = (1, 1) and
    (2, 2); the port saves that state again, and its manifest has the JAX
    manifest's ``leaves`` and its ``.npy`` files are byte-identical to the
    JAX package's; the JAX package's ``ckpt.restore`` reads the port's
    checkpoint with the JAX trainer's templates bitwise; and a JAX trainer
    resumed from a port checkpoint takes its next step with the port's
    loss within ``tests/test_torch_train.py``'s 1e-3.
  * The twin of ``tests/test_train.py::test_restart_after_injected_failure``
    (smoke gpt-350m, 20 steps, a checkpoint every 10, a failure injected at
    step 13): final params and optimizer state bitwise the uninterrupted
    run's, under ``baseline`` and ``tp=taco`` (the plain versions).
  * The runtime: ``replan`` gives the JAX package's verdict and reason on a
    grid of (tp, fsdp) pairs with rejections in it; ``elastic_restore``
    builds a trainer or refuses; ``StepWatchdog``, ``FailureInjector`` and
    ``RetryPolicy`` behave as the JAX package's on the same inputs.
  * The serve launcher's ``--ckpt``: from a port trainer checkpoint (the
    ``['params']`` subtree) the engine's params are the trainer's and its
    greedy tokens those of an engine built from the in-memory params; from
    a JAX params-only checkpoint, the params are the JAX params.
"""
from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.configs import get_config, make_plan, smoke_config
from repro.core.parallel import ParallelCtx
from repro.core.registry import from_spec
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models.model import Model
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.ckpt import checkpoint as ck
from repro_torch.core.parallel import ParallelCtx as TCtx
from repro_torch.core.registry import from_spec as tfrom_spec
from repro_torch.data import pipeline as tpipe
from repro_torch.models.model import Model as TModel
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import elastic, fault_tolerance as tft
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig

SEQ, BATCH = 64, 2
OPT = dict(lr_max=1e-3, lr_min=1e-4, warmup_steps=2, total_steps=10)
SPEC = "baseline"


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one intra-op thread: under the suite's parallel workers
    (and the JAX package's threads in the same process) torch's default of
    one thread a core oversubscribes the machine and small steps crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(r.normal(size=(16, 8)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(r.integers(0, 10, (4,))
                                         .astype(np.int32)),
                   "c": torch.from_numpy(r.normal(size=(3, 3, 3))
                                         .astype(np.float32)).bfloat16()},
    }


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tadamw.leaves(a),
                                                  tadamw.leaves(b)))


# --------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# --------------------------------------------------------------------------

def test_roundtrip_bit_exact(tmp_path):
    state = tree()
    ck.save(str(tmp_path), 7, state)
    back, step = ck.restore(str(tmp_path), state)
    assert step == 7
    for a, b in zip(tadamw.leaves(state), tadamw.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_gc(tmp_path):
    state = tree()
    for s in [1, 2, 3, 4, 5]:
        ck.save(str(tmp_path), s, state, keep_last=2)
    assert ck.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 2


def test_interrupted_save_not_visible(tmp_path):
    state = tree()
    ck.save(str(tmp_path), 3, state)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ck.latest_step(str(tmp_path)) == 3
    os.makedirs(tmp_path / "step_00000010")
    assert ck.latest_step(str(tmp_path)) == 3


def test_restore_latest_by_default(tmp_path):
    s1, s2 = tree(1), tree(2)
    ck.save(str(tmp_path), 1, s1)
    ck.save(str(tmp_path), 2, s2)
    back, step = ck.restore(str(tmp_path), s1)
    assert step == 2
    assert torch.equal(back["a"], s2["a"])


def test_comm_spec_persist_and_validate(tmp_path):
    state = tree()
    spec = "tp=taco:folded,grad_rs=sdp4bit"
    ck.save(str(tmp_path), 5, state, comm_spec=spec)
    assert ck.read_comm_spec(str(tmp_path)) == spec
    _, step = ck.restore(str(tmp_path), state, expect_comm_spec=spec)
    assert step == 5
    with pytest.raises(ck.CommSpecMismatch) as ei:
        ck.restore(str(tmp_path), state, expect_comm_spec="baseline")
    assert spec in str(ei.value) and "baseline" in str(ei.value)
    ck.restore(str(tmp_path), state)


def test_comm_spec_absent_in_old_checkpoints(tmp_path):
    state = tree()
    ck.save(str(tmp_path), 2, state)
    assert ck.read_comm_spec(str(tmp_path)) is None
    _, step = ck.restore(str(tmp_path), state, expect_comm_spec="tp=taco")
    assert step == 2
    assert ck.read_comm_spec(str(tmp_path / "missing")) is None


def test_mismatched_template_names_the_key(tmp_path):
    state = tree()
    ck.save(str(tmp_path), 1, state)
    bad = tree()
    bad["nested"]["c"] = bad["nested"]["c"].float()
    with pytest.raises(ValueError, match=r"\['nested'\]\['c'\].*bfloat16"):
        ck.restore(str(tmp_path), bad)
    bad = tree()
    bad["a"] = bad["a"][:8]
    with pytest.raises(ValueError, match=r"\['a'\].*\[16, 8\]"):
        ck.restore(str(tmp_path), bad)
    with pytest.raises(ValueError, match="3 leaves.*template 2"):
        ck.restore(str(tmp_path), {"a": state["a"], "b": state["a"]})
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "missing"), state)


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

def _jsetup():
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, 1, 1))
    data = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH), cfg)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    return model, data, mesh


def _tmodel(tp=1, fsdp=1, **kw):
    cfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-0.5b"))
    return TModel(cfg, tconfigs.make_plan(cfg, tp, fsdp), device="cpu", **kw)


def _ttrainer(model, ckpt_dir, total_steps=2, every=2, spec=SPEC, **kw):
    cfg = model.cfg
    data = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, SEQ, BATCH),
                             cfg)
    return TTrainer(model, TCtx(plan=tfrom_spec(spec)),
                    tadamw.OptConfig(**OPT),
                    TTrainerConfig(total_steps=total_steps, ckpt_every=every,
                                   ckpt_dir=str(ckpt_dir)), data, **kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's checkpoint after 2 steps, and its state."""
    from repro.train.trainer import Trainer, TrainerConfig
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    model, data, mesh = _jsetup()
    tr = Trainer(model, mesh, ParallelCtx(plan=from_spec(SPEC)),
                 jadamw.OptConfig(**OPT),
                 TrainerConfig(total_steps=2, ckpt_every=2, log_every=100,
                               ckpt_dir=str(tmp / "jax")), data)
    params, opt, _ = tr.run(resume=False)
    return tmp, jax.device_get({"params": params, "opt": opt})


def _raw(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _cut(a, spec, model):
    """The rank's shard of a global numpy array, cut here by np.split."""
    for dim, n, r in ((spec.tp_dim, model.plan.tp, model.tp_rank),
                      (spec.fsdp_dim, model.plan.fsdp, model.fsdp_rank)):
        if dim is not None and n > 1:
            a = np.split(a, n, axis=dim)[r]
    return a


@pytest.mark.parametrize("tp,fsdp", [(1, 1), (2, 2)])
def test_port_restores_the_jax_trainers_checkpoint_cut_to_each_rank(
        jax_run, tp, fsdp):
    tmp, state = jax_run
    jleaves = jax.tree_util.tree_leaves
    for r in range(tp * fsdp):
        model = _tmodel(tp, fsdp, tp_rank=r % tp, fsdp_rank=r // tp)
        tr = _ttrainer(model, tmp / "jax")
        params, opt, step = tr.try_restore(*tr.init_state()[:2])
        assert step == 2 and opt["step"] == 2
        specs = tadamw.leaves(model.specs())
        for key, tree in (("params", params), ("master", opt["master"]),
                          ("mu", opt["mu"]), ("nu", opt["nu"])):
            want = jleaves(state["params"] if key == "params"
                           else state["opt"][key])
            for spec, got, w in zip(specs, tadamw.leaves(tree), want,
                                    strict=True):
                exp = _cut(_raw(w), spec, model)
                raw = got.view(torch.int16) if got.dtype == torch.bfloat16 \
                    else got
                np.testing.assert_array_equal(raw.numpy(), exp)


def _manifest(d):
    return json.loads((d / "manifest.json").read_text())


def test_port_saves_the_jax_packages_bytes_and_jax_reads_them(jax_run):
    tmp, state = jax_run
    tr = _ttrainer(_tmodel(), tmp / "jax")
    params, opt, step = tr.try_restore(*tr.init_state()[:2])
    tr.tc.ckpt_dir = str(tmp / "port")
    tr.save(step, params, opt)
    jdir, pdir = tmp / "jax" / "step_00000002", tmp / "port" / "step_00000002"
    jm, pm = _manifest(jdir), _manifest(pdir)
    assert pm["leaves"] == jm["leaves"] and len(pm["leaves"]) == 57
    assert pm["step"] == jm["step"] == 2
    assert pm["comm_spec"] == jm["comm_spec"] == SPEC
    for leaf in jm["leaves"]:
        assert (pdir / leaf["file"]).read_bytes() == \
            (jdir / leaf["file"]).read_bytes(), leaf["key"]
    model, _, _ = _jsetup()
    tmpl = {"params": model.init(jax.random.PRNGKey(1)),
            "opt": jadamw.init_opt_state(model.init(jax.random.PRNGKey(1)))}
    back, jstep = jck.restore(str(tmp / "port"), tmpl,
                              expect_comm_spec=SPEC)
    assert jstep == 2
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state), strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_raw(a), _raw(b))


def test_jax_trainer_resumes_from_a_port_checkpoint(tmp_path):
    """The port trains 3 steps from the JAX trainer's initial weights and
    saves at step 2; the JAX trainer resumes from that checkpoint and
    takes step 2: its loss within 1e-3 of the port's."""
    from repro.train.trainer import Trainer, TrainerConfig
    model, data, mesh = _jsetup()
    init = jax.device_get(model.init(jax.random.PRNGKey(0)))
    tmodel = _tmodel()
    ttr = _ttrainer(tmodel, tmp_path / "port", total_steps=3)
    _, _, hist = ttr.run(resume=False, params=tmodel.from_jax_params(init))
    shutil.copytree(tmp_path / "port" / "step_00000002",
                    tmp_path / "resume" / "step_00000002")
    jtr = Trainer(model, mesh, ParallelCtx(plan=from_spec(SPEC)),
                  jadamw.OptConfig(**OPT),
                  TrainerConfig(total_steps=3, ckpt_every=100, log_every=100,
                                ckpt_dir=str(tmp_path / "resume")), data)
    _, _, jlosses = jtr.run(resume=True)
    assert len(jlosses) == 1 and hist[2]["step"] == 2
    assert abs(jlosses[0] - hist[2]["loss"]) / jlosses[0] < 1e-3, \
        (jlosses, hist[2]["loss"])


def test_trainer_refuses_a_checkpoint_of_another_comm_spec(tmp_path):
    model = _tmodel()
    _ttrainer(model, tmp_path, spec="tp=taco").run(resume=False)
    tr = _ttrainer(model, tmp_path, spec="baseline")
    with pytest.raises(ck.CommSpecMismatch, match="tp=taco"):
        tr.run(resume=True)


# --------------------------------------------------------------------------
# restart after an injected failure
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["baseline", "tp=taco"])
def test_restart_after_injected_failure(tmp_path, spec):
    cfg = tconfigs.smoke_config(tconfigs.get_config("gpt-350m"))
    model = TModel(cfg, tconfigs.make_plan(cfg, 1, 1), device="cpu")
    data = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, 64, 8), cfg)
    oc = tadamw.OptConfig(lr_max=1e-3, lr_min=1e-4, warmup_steps=5,
                          total_steps=20)

    def trainer(ckpt_dir, injector=None):
        tc = TTrainerConfig(total_steps=20, ckpt_every=10,
                            ckpt_dir=str(ckpt_dir))
        return TTrainer(model, TCtx(plan=tfrom_spec(spec)), oc, tc, data,
                        injector=injector)
    p_ref, o_ref, h_ref = trainer(tmp_path / "ref").run(resume=False)
    tr = trainer(tmp_path / "fail", tft.FailureInjector(fail_at_steps=[13]))
    p_failed, o_failed, h_failed = tr.run(resume=False)
    assert tr.injector.fired == {13}
    assert _equal(p_ref, p_failed)
    assert _equal({k: o_ref[k] for k in ("master", "mu", "nu")},
                  {k: o_failed[k] for k in ("master", "mu", "nu")})
    assert o_ref["step"] == o_failed["step"] == 20
    assert [h["loss"] for h in h_ref] == [h["loss"] for h in h_failed]
    assert [h["step"] for h in h_failed] == list(range(20))


# --------------------------------------------------------------------------
# the runtime
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gpt-2.7b"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_replan_gives_the_reference_verdict(arch, smoke):
    from repro.runtime.elastic import replan as jreplan
    jcfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    if smoke:
        jcfg, tcfg = smoke_config(jcfg), tconfigs.smoke_config(tcfg)
    verdicts = []
    for old in ((1, 1), (2, 4)):
        jold, told = make_plan(jcfg, *old), tconfigs.make_plan(tcfg, *old)
        for tp in (1, 2, 4, 8):
            for fsdp in (1, 4, 16):
                want = jreplan(jcfg, jold, tp, fsdp)
                got = elastic.replan(tcfg, told, tp, fsdp)
                assert (got.ok, got.reason) == (want.ok, want.reason)
                assert dataclasses_equal(got.new_plan, want.new_plan)
                verdicts.append(got.ok)
    assert True in verdicts
    if arch == "qwen2-0.5b":
        assert False in verdicts


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_elastic_restore_builds_a_trainer_or_refuses(tmp_path):
    from repro_torch.launch.mesh import Mesh
    cfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-0.5b"))
    old = tconfigs.make_plan(cfg, 1, 1)
    data = tpipe.SyntheticLM(tpipe.DataConfig(cfg.vocab_size, SEQ, BATCH))

    def factory(cfg, plan, mesh):
        return TModel(cfg, plan, device="cpu", **mesh.model_kwargs())
    args = (tadamw.OptConfig(**OPT), TTrainerConfig(ckpt_dir=str(tmp_path)),
            data)
    tr = elastic.elastic_restore(TTrainer, factory, cfg, old,
                                 Mesh((1, 1, 1)), tfrom_spec(SPEC), *args)
    assert isinstance(tr, TTrainer) and tr.model.plan == old
    assert tr.comm_spec == SPEC
    with pytest.raises(ValueError, match="kv_mode: sharded -> replicated"):
        elastic.elastic_restore(TTrainer, factory, cfg, old, Mesh((1, 1, 2)),
                                tfrom_spec(SPEC), *args)


def test_watchdog_injector_and_retry_policy_match_the_reference():
    from repro.runtime import fault_tolerance as jft
    gen = np.random.default_rng(3)
    times = list(gen.uniform(0.9, 1.1, 130))
    for i in (7, 40, 101, 125):
        times[i] = 4.0
    for window in (50, 10):
        a = tft.StepWatchdog(window=window)
        b = jft.StepWatchdog(window=window)
        assert [a.observe(t) for t in times] == [b.observe(t) for t in times]
        assert a.stragglers == b.stragglers > 0
        assert a._times == b._times
    a, b = tft.FailureInjector([2, 5]), jft.FailureInjector([2, 5])
    for step in (0, 2, 2, 5, 3, 5):
        outs = []
        for inj in (a, b):
            try:
                inj.maybe_fail(step)
                outs.append(None)
            except RuntimeError as exc:
                outs.append(str(exc))
        assert outs[0] == outs[1]
    assert a.fired == b.fired == {2, 5}
    a, b = tft.RetryPolicy(max_restarts=2), jft.RetryPolicy(max_restarts=2)
    exc = RuntimeError("boom")
    assert [a.should_retry(exc) for _ in range(4)] == \
        [b.should_retry(exc) for _ in range(4)] == [True, True, False, False]
    assert a.restarts == b.restarts == 4


# --------------------------------------------------------------------------
# the serve launcher's --ckpt
# --------------------------------------------------------------------------

SERVE_ARGS = ["--device", "cpu", "--requests", "2", "--prompt-len", "4",
              "--gen", "5", "--max-batch", "2", "--comm-spec", SPEC]


def _greedy(eng):
    gen = np.random.default_rng(5)
    reqs = [eng.submit(gen.integers(0, 503, 4).astype(np.int32), max_new=5)
            for _ in range(2)]
    eng.run_until_drained()
    return [r.tokens for r in reqs]


def test_serve_ckpt_from_a_port_trainer_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServeEngine
    params, _, _ = _ttrainer(_tmodel(), tmp_path).run(resume=False)
    eng, _ = serve.build_engine(serve.parse_args(
        SERVE_ARGS + ["--ckpt", str(tmp_path)]))
    out = capsys.readouterr().out
    assert f"checkpoint was trained with comm spec: {SPEC}" in out
    assert "restored checkpoint step 2" in out
    assert _equal(eng.params, params)
    mem = ServeEngine(eng.model, eng.ctx, params, max_batch=eng.max_batch,
                      max_len=eng.max_len, prefill_buckets=eng.buckets,
                      device="cpu")
    toks = _greedy(eng)
    assert toks == _greedy(mem) and all(len(t) == 5 for t in toks)


def test_serve_ckpt_from_a_jax_params_only_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve
    model, _, _ = _jsetup()
    jparams = jax.device_get(model.init(jax.random.PRNGKey(7)))
    jck.save(str(tmp_path), 0, jparams)
    eng, _ = serve.build_engine(serve.parse_args(
        SERVE_ARGS + ["--ckpt", str(tmp_path)]))
    assert "restored checkpoint step 0" in capsys.readouterr().out
    assert _equal(eng.params, eng.model.from_jax_params(jparams))
    assert all(len(t) == 5 for t in _greedy(eng))
