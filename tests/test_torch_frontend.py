"""The patch frontend of the port (internvl2-1b: a dense qwen2-like language
model with stub patch embeddings put in front of the token embedding)
held against the JAX package, with ``build_eval_step``.

The patches join the embedding's tp-partial output on TP rank 0 only,
before its reduce-scatter, and the labels and the mask get zeros in front
of them (``transformer.forward_train``).  Smoke internvl2-1b (2 layers,
d 128, 8 / 1 heads of 16, d_ff 192, vocab 503, 8 patches) in bf16,
weights carried by ``Model.from_jax_params``, batches from both packages'
``SyntheticLM`` (equal bit for bit), at the bounds of
``tests/test_torch_encdec.py`` (whose helpers this file reuses): one
step's loss and grads and teacher-forced decode logits at tp = 1 and at
tp = 2 (a gloo world of 2 against the JAX package at 2 forced host
devices, in one subprocess), the eval step (also over a data group of
2), the hops of a step, the spec
trees, the pipeline step's refusal and both launchers.
"""
from __future__ import annotations

import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_encdec as E
from repro_torch import configs as tconfigs
from repro_torch.core.parallel import ParallelCtx as TCtx
from repro_torch.core.registry import from_spec as tfrom_spec
from test_torch_dist import one_thread  # noqa: F401  (autouse)

INTERNVL = "internvl2-1b"


@pytest.fixture(scope="module")
def tp1():
    model, tmodel = E.models(INTERNVL)
    smodel, tsmodel = E.models(INTERNVL, remat=False)
    params = model.init(jax.random.PRNGKey(0))
    jb, tb = E.batches(INTERNVL)
    toks = E.decode_tokens(model.cfg.vocab_size)
    cache = E.cross_cache(smodel)
    ref = {"tree": jax.device_get(params), "jb": jb, "tb": tb, "toks": toks,
           "cache": cache, "model": model, "params": params,
           "tmodel": tmodel, "tsmodel": tsmodel}
    for spec in E.SPECS:
        ref[("step", spec)] = E.jax_step(model, params, jb, spec)
        ref[("decode", spec)] = E.jax_decode(smodel, params, spec, toks,
                                             cache)
    ref["eval"] = E.jax_eval(model, params, jb, "baseline")
    return ref


@pytest.mark.parametrize("step", [0, 3])
def test_patch_batches_are_the_references_bit_for_bit(step):
    jb, tb = E.batches(INTERNVL, seq=32, batch=3, step=step)
    assert sorted(tb) == sorted(jb) == ["labels", "mask", "patches",
                                        "tokens"]
    assert tb["patches"].dtype == torch.bfloat16
    assert tb["patches"].shape == (3, 8, 128) and tb["tokens"].shape == \
        (3, 24)
    for k in jb:
        want = np.asarray(jb[k])
        got = tb[k]
        if k == "patches":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tp", [1, 2])
def test_spec_tree_is_the_references(tp):
    jrows, trows = E.spec_rows(INTERNVL, tp)
    assert trows == jrows
    assert not any("enc_" in r[0] or "xattn" in r[0] for r in trows)


def test_full_size_batch_shapes():
    cfg = E.get_config(INTERNVL)
    jm = E.Model(cfg, E.make_plan(cfg, 1, 1))
    tcfg = tconfigs.get_config(INTERNVL)
    tm = E.TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu")
    want = {k: s.shape for k, s in jm.batch_shape(2048, 4).items()}
    got = tm.batch_shape(2048, 4)
    assert {k: v[0] for k, v in got.items()} == want
    assert want["patches"] == (4, 256, 896) and want["tokens"] == (4, 1792)


@pytest.mark.parametrize("spec", sorted(E.SPECS))
def test_tp1_train_step_matches_jax(tp1, spec):
    port = E.port_step(tp1["tmodel"], tp1["tree"], tp1["tb"], spec)
    E.check_step(port, tp1[("step", spec)], spec)


@pytest.mark.parametrize("spec", sorted(E.TOL))
def test_tp1_decode_matches_jax(tp1, spec):
    port = E.port_decode(tp1["tsmodel"], tp1["tree"], spec, tp1["toks"],
                         tp1["cache"])
    E.check_decode(port, tp1[("decode", spec)], spec)


def test_patch_positions_carry_no_loss(tp1):
    """The labels and the mask get zeros in front of the patches: the token
    count is the tokens' alone, and the patches still move the loss
    through attention."""
    tmodel = tp1["tmodel"]
    params = tmodel.from_jax_params(tp1["tree"])
    ctx = TCtx(plan=tfrom_spec("baseline"))
    with torch.no_grad():
        loss_sum, count, _ = tmodel.loss_parts(params, tp1["tb"], ctx)
        b, s = tp1["tb"]["tokens"].shape
        assert float(count) == b * s
        other = dict(tp1["tb"], patches=torch.zeros_like(
            tp1["tb"]["patches"]))
        loss_other, count_other, _ = tmodel.loss_parts(params, other, ctx)
    assert float(count_other) == b * s
    assert float(loss_other) != float(loss_sum)


def test_eval_step_matches_jax(tp1):
    from repro_torch.train.train_step import build_eval_step
    tmodel = tp1["tmodel"]
    step = build_eval_step(tmodel, TCtx(plan=tfrom_spec("baseline")))
    loss = step(tmodel.from_jax_params(tp1["tree"]), tp1["tb"])
    assert abs(float(loss) - tp1["eval"]) / tp1["eval"] < E.LOSS_TOL
    assert abs(float(loss) - tp1[("step", "baseline")][0]) \
        / tp1["eval"] < E.LOSS_TOL


@pytest.mark.parametrize("policy", ["full", "none"])
def test_hops_per_step_are_the_derived_count(policy, monkeypatch):
    """The patches join the embedding before its exit: no hop of their
    own, the dense model's count."""
    from repro_torch.models import transformer as tt
    _, tmodel = E.models(INTERNVL, remat=policy != "none",
                         remat_policy=policy)
    calls = E.count_step_ops(tmodel, E.batches(INTERNVL, seq=32)[1], "taco",
                             monkeypatch)
    hops = tt.tp_hops_per_step(tmodel.cfg, tmodel.plan, tfrom_spec("taco"))
    assert calls == E.want_ops(hops)
    n = tmodel.cfg.n_layers
    assert (hops["all_gather"], hops["reduce_scatter"]) == (
        (6 * n + 2, 5 * n + 2) if policy == "full" else (4 * n + 2,
                                                         4 * n + 2))


def test_pipeline_step_refuses_the_patch_frontend():
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline_parallel as tpl
    tcfg = E.cfgs(INTERNVL)[1]
    model = E.TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu",
                     fsdp_axes=("data",))
    with pytest.raises(NotImplementedError,
                       match=r"'patches'.*pipeline_parallel\.py:115-116"):
        tpl.build_pipeline_train_step(
            model, TCtx(plan=tfrom_spec("baseline"), fsdp_axes=("data",)),
            adamw.OptConfig(**E.OPT), tpl.PipeConfig(stages=1,
                                                     microbatches=2))


def test_a_seq_axis_is_refused_as_the_reference_refuses_it():
    cfg, tcfg = E.cfgs(INTERNVL)
    jm = E.Model(cfg, E.make_plan(cfg, 1, 1), sp_axis="seq")
    with pytest.raises(NotImplementedError, match="encdec/patches"):
        jm.batch_pspecs()
    with pytest.raises(NotImplementedError, match="encdec/patches"):
        E.TModel(tcfg, tconfigs.make_plan(tcfg, 1, 1), device="cpu",
                 sp_axis="seq", sp=2, sp_rank=0)


def test_launchers_train_and_serve_internvl_smoke(capsys):
    from repro_torch.launch import serve, train
    args = train.parse_args(["--arch", INTERNVL, "--smoke", "--device",
                             "cpu", "--steps", "2", "--seq", "32",
                             "--batch", "2", "--comm-spec",
                             "tp=taco,warmup=1"])
    trainer, cfg = train.build_trainer(args)
    assert cfg.frontend == "patches"
    hist = trainer.run()[2]
    assert [h["plan"] for h in hist] == ["baseline", "tp=taco"]
    assert all(np.isfinite(h["loss"]) for h in hist)
    s = serve.main(["--arch", INTERNVL, "--smoke", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "4", "--gen", "4",
                    "--max-batch", "2", "--comm-spec", "taco"])
    assert s["requests"] == 3 and s["total_new_tokens"] == 12
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return E.run_tp2(INTERNVL, __file__, tmp_path_factory)


@pytest.mark.parametrize("spec", sorted(E.SPECS))
def test_tp2_train_step_matches_jax(tp2, spec):
    """Rank 0 puts the patches into its tp-partial embedding, rank 1
    zeros; the reduce-scatter sums them."""
    E.check_tp2_step(INTERNVL, tp2, spec)


@pytest.mark.parametrize("spec", sorted(E.TOL))
def test_tp2_decode_matches_jax(tp2, spec):
    E.check_tp2_decode(tp2, spec)


def test_eval_step_over_a_data_group_matches_jax(tp2):
    E.check_dp_eval(tp2)


if __name__ == "__main__":
    E.jax_reference(INTERNVL, sys.argv[1])
