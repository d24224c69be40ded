"""The training loop with checkpoint / restart, failure injection and the
step watchdog — the JAX package's ``repro/train/trainer.py``.

The trainer hands every step to a ``core/policy.py`` ``PolicyEngine``:
the engine resolves the plan that runs the step (``ctx.plan.at_step``:
the identity plan during ``warmup=``, the steady plan after; then every
controller's proposal — a negotiated wire bound under ``slot=auto``, a
fallback codec under ``escalate=``), takes the step function built for
that plan (one per plan variant, cached), and ticks its controllers after
the step, replaying a step whose negotiated bound overflowed.  The step
runs on this data rank's rows of the step's global batch.  Its update
writes the parameters and the optimizer state in place, so the step runs
in two phases (``train_step.TrainStep``): the engine runs the phase with
every hop of the step (forward, backward, the ``grad_rs``
reduce-scatters), decides, and only the attempt that stands is applied
— a replay starts from untouched state, with no copy of it.  Each
history row holds the step's metrics, the plan's ``comm/*`` wire
accounting (``core/telemetry.py``) and the engine's controller counters.

The loop is restart-oriented: all state is (params, opt_state, step), and
the data pipeline is a pure function of step.  With ``tc.ckpt_dir`` set,
the state is saved every ``tc.ckpt_every`` steps and at the last one
(``ckpt/checkpoint.py``: the global arrays, gathered from every rank's
shards; rank 0 writes), ``run(resume=True)`` starts from the latest
checkpoint, and a step that raises (an ``injector`` failure or a real
one) restores the latest checkpoint and replays from it, up to
``RetryPolicy.max_restarts`` times — bitwise, as an uninterrupted run.
``tc.ckpt_dir=None`` (the default) saves nothing.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import collectives as cc
from repro_torch.core import policy, telemetry
from repro_torch.core.registry import to_spec
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (FailureInjector, RetryPolicy,
                                                 StepWatchdog)
from repro_torch.train.train_step import build_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str | None = None     # None: no checkpoint
    keep_last: int = 3
    seed: int = 0


class Trainer:
    """``Trainer(model, ctx, oc, tc, data).run()``; the parameters live on
    ``model.device``.  ``build_step(model, ctx, oc)`` builds the
    ``train_step.TrainStep`` of a plan: ``train_step.build_train_step`` by
    default, or a pipeline step (``train/pipeline_parallel.py``)."""

    def __init__(self, model, ctx, oc: adamw.OptConfig, tc: TrainerConfig,
                 data, injector: FailureInjector | None = None,
                 build_step=build_train_step):
        self.model, self.ctx, self.oc, self.tc = model, ctx, oc, tc
        self.data, self.build_step = data, build_step
        self.injector = injector
        self.comm_spec = to_spec(ctx.plan)
        self.watchdog = StepWatchdog()
        self.history: list[dict] = []
        self.reporter = telemetry.Reporter(log)
        # the engine owns plan resolution, the per-plan step cache and the
        # replay protocol; default_controllers attaches what the plan asks
        # for (slot=auto / escalate= paths)
        self.policy = policy.PolicyEngine(
            ctx.plan, self._build_step,
            controllers=policy.default_controllers(
                ctx.plan, reporter=self.reporter))
        log.info("comm plan: %s%s", self.comm_spec,
                 f" [{len(self.policy.controllers)} policy controller(s)]"
                 if self.policy.controllers else "")

    @property
    def losses(self) -> list[float]:
        return [h["loss"] for h in self.history]

    @property
    def slots(self):
        """The engine's ``SlotController`` when a path runs under
        ``slot=auto``, else None."""
        return self.policy.controller(cc.SlotController)

    def _build_step(self, plan):
        """The engine's build callback: the step of one plan variant."""
        return self.build_step(
            self.model, dataclasses.replace(self.ctx, plan=plan), self.oc)

    def step_fn_for(self, step: int):
        """The step function of the plan variant active at ``step``
        (warmup and every controller's proposal resolved by the engine,
        outside the step)."""
        return self.policy.fn_for(step)[0]

    def _attempt(self, fn, params, batch):
        """One attempt at a step: every hop of it, nothing written
        (``TrainStep.grads``); the engine decides whether it stands."""
        return fn, fn.grads(params, batch)

    # ---- state ------------------------------------------------------------
    def init_state(self, params=None):
        """Parameters from ``tc.seed`` (or the given ones), fresh AdamW
        state, step 0."""
        if params is None:
            params = self.model.init(self.tc.seed)
        return params, adamw.init_opt_state(params), 0

    def save(self, step: int, params, opt_state) -> None:
        """Write the state as ``step``: every leaf of the parameter layout
        gathered to its global (padded) array on the host
        (``Model.gather_params``; every rank of the mesh takes part), the
        step count as it is; rank 0 of the world writes, and every rank
        returns once the checkpoint is committed.  On the seq mesh every
        seq rank holds the same parameters and state, so the gathers run
        over the pipe, fsdp and TP groups only and the state is written
        once; a restore cuts every seq rank the same leaves."""
        def host(tree):
            return self.model.gather_params(tree, self.ctx)
        state = {"params": host(params),
                 "opt": {"master": host(opt_state["master"]),
                         "mu": host(opt_state["mu"]),
                         "nu": host(opt_state["nu"]),
                         "step": opt_state["step"]}}
        if not dist.is_initialized() or dist.get_rank() == 0:
            ckpt.save(self.tc.ckpt_dir, step, state,
                      keep_last=self.tc.keep_last, comm_spec=self.comm_spec)
        if dist.is_initialized():
            dist.barrier()

    def try_restore(self, params, opt_state):
        """``(params, opt_state, step)`` from the latest checkpoint in
        ``tc.ckpt_dir``, or None when there is none.  Every rank reads the
        global arrays and cuts its own shards (``Model.cut_params``); the
        checkpoint must have been saved under this run's comm spec
        (``ckpt.CommSpecMismatch`` otherwise) and in these global shapes
        and dtypes."""
        step = ckpt.latest_step(self.tc.ckpt_dir)
        if step is None:
            return None
        specs = self.model.specs()

        def meta(spec, like):
            return torch.empty(spec.shape, dtype=like.dtype, device="meta")
        f32 = tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                             device="meta"), specs)
        template = {"params": tree_map(meta, specs, params),
                    "opt": {"master": f32, "mu": f32, "nu": f32,
                            "step": opt_state["step"]}}
        state, step = ckpt.restore(self.tc.ckpt_dir, template, step,
                                   device="cpu",
                                   expect_comm_spec=self.comm_spec)
        cut = self.model.cut_params
        opt = state["opt"]
        log.info("restored checkpoint at step %d", step)
        return (cut(state["params"]),
                {"master": cut(opt["master"]), "mu": cut(opt["mu"]),
                 "nu": cut(opt["nu"]), "step": opt["step"]}, step)

    # ---- loop -------------------------------------------------------------
    def run(self, resume: bool = True, params=None):
        """Run to ``tc.total_steps`` from step 0, or from the latest
        checkpoint when ``resume`` and ``tc.ckpt_dir`` has one.  Returns
        ``(params, opt_state, history)``; each history row holds the step's
        loss, grad_norm, lr, wall ms, tokens/s of the global batch, plan
        spec and ``comm/*`` keys.  A replayed step's row replaces the row
        of its failed run, so the history has one row a step.  ``params``
        (default: from ``tc.seed``) are updated in place; a replay from
        step 0 starts from a copy taken here."""
        first = None if params is None else tree_map(torch.clone, params)
        params, opt_state, step = self.init_state(params)
        if resume and self.tc.ckpt_dir is not None:
            restored = self.try_restore(params, opt_state)
            if restored is not None:
                params, opt_state, step = restored
        retry = RetryPolicy()
        dev = self.model.device
        while step < self.tc.total_steps:
            try:
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                params, opt_state = self._step(step, params, opt_state, dev)
                step += 1
                if self.tc.ckpt_dir is not None and (
                        step % self.tc.ckpt_every == 0
                        or step == self.tc.total_steps):
                    self.save(step, params, opt_state)
            except Exception as exc:  # noqa: BLE001 — the restart boundary
                if not retry.should_retry(exc):
                    raise
                restored = None
                if self.tc.ckpt_dir is not None:
                    restored = self.try_restore(params, opt_state)
                if restored is None:
                    restored = self.init_state(
                        None if first is None else tree_map(torch.clone,
                                                            first))
                params, opt_state, step = restored
                self.history = [h for h in self.history if h["step"] < step]
        return params, opt_state, self.history

    def _step(self, step: int, params, opt_state, dev):
        glob = self.data.batch(step)
        batch = self.data.place(self.model.batch_slice(glob), dev)
        t0 = time.perf_counter()
        # resolve, run every hop, tick the controllers, replay an attempt
        # whose negotiated bound overflowed; then apply the one that stood
        (fn, (grads, loss)), plan = self.policy.run(
            step, lambda fn: self._attempt(fn, params, batch))
        params, opt_state, metrics = fn.apply(params, opt_state, grads, loss)
        del grads
        loss = float(metrics["loss"])          # waits for the step
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.watchdog.observe(dt)
        row = {"step": step, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]),
               "lr": metrics["lr"], "ms": dt * 1e3,
               "tok_per_s": glob["mask"].numel() / dt,
               "plan": to_spec(plan)}
        row.update(telemetry.comm_metrics(
            plan, spec=self.comm_spec,
            warmup_active=self.policy.warmup_active(step)))
        row.update(self.policy.metrics())
        self.history.append(row)
        if step % self.tc.log_every == 0:
            log.info("step %d loss %.4f gnorm %.3f lr %.2e (%.1f ms)",
                     step, loss, row["grad_norm"], row["lr"], row["ms"])
        return params, opt_state
