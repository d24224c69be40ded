"""The training loop — the JAX package's ``repro/train/trainer.py`` without
its restart machinery.

Each step resolves the plan that runs it (``ctx.plan.at_step``: the
identity plan during ``warmup=``, the steady plan after), takes the step
function built for that plan (one per plan, cached), runs it on this
data rank's rows of the step's global batch and records the step's
metrics, the plan's ``comm/*`` wire accounting among them
(``core/telemetry.py``).  Checkpoint / restart, fault
injection and the ``PolicyEngine`` controllers (``slot=auto``,
``escalate=``) are not in this slice: asking for any of them raises.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import torch

from repro_torch.core import telemetry
from repro_torch.core.registry import to_spec
from repro_torch.optim import adamw
from repro_torch.train.train_step import build_train_step

log = logging.getLogger("repro_torch.trainer")

NOT_IN_SLICE = ("is not in the port's training slice yet (ROADMAP: "
                "checkpoint/restart, fault injection and the policy "
                "controllers come later)")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    seed: int = 0
    ckpt_every: int | None = None   # not in this slice: must stay None
    ckpt_dir: str | None = None     # not in this slice: must stay None


class Trainer:
    """``Trainer(model, ctx, oc, tc, data).run(steps)``; the parameters
    live on ``model.device``.  ``build_step(model, ctx, oc)`` builds the
    step function of a plan: ``train_step.build_train_step`` by default, or
    a pipeline step (``train/pipeline_parallel.py``)."""

    def __init__(self, model, ctx, oc: adamw.OptConfig, tc: TrainerConfig,
                 data, injector=None, build_step=build_train_step):
        if injector is not None:
            raise NotImplementedError(f"fault injection {NOT_IN_SLICE}")
        if tc.ckpt_dir is not None or tc.ckpt_every is not None:
            raise NotImplementedError(f"checkpoint/restart {NOT_IN_SLICE}")
        self.model, self.ctx, self.oc, self.tc = model, ctx, oc, tc
        self.data, self.build_step = data, build_step
        self.comm_spec = to_spec(ctx.plan)
        self.history: list[dict] = []
        self._steps: dict = {}
        log.info("comm plan: %s", self.comm_spec)

    @property
    def losses(self) -> list[float]:
        return [h["loss"] for h in self.history]

    def step_fn_for(self, step: int):
        """The step function of the plan active at ``step`` (warmup
        resolved here, outside the step)."""
        plan = self.ctx.plan.at_step(step)
        if plan not in self._steps:
            self._steps[plan] = self.build_step(
                self.model, dataclasses.replace(self.ctx, plan=plan),
                self.oc)
        return self._steps[plan]

    def init_state(self, params=None):
        """Parameters from ``tc.seed`` (or the given ones), fresh AdamW
        state, step 0."""
        if params is None:
            params = self.model.init(self.tc.seed)
        return params, adamw.init_opt_state(params), 0

    def run(self, steps: int | None = None, params=None):
        """Run ``steps`` optimizer steps (default ``tc.total_steps``) from
        step 0.  Returns ``(params, opt_state, history)``; each history row
        holds the step's loss, grad_norm, lr, wall ms, tokens/s of the
        global batch, plan spec and ``comm/*`` keys."""
        steps = self.tc.total_steps if steps is None else steps
        params, opt_state, start = self.init_state(params)
        dev = self.model.device
        for step in range(start, start + steps):
            glob = self.data.batch(step)
            batch = self.data.place(self.model.batch_slice(glob), dev)
            fn = self.step_fn_for(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = fn(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            plan = self.ctx.plan.at_step(step)
            row = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": metrics["lr"], "ms": dt * 1e3,
                   "tok_per_s": glob["mask"].numel() / dt,
                   "plan": to_spec(plan)}
            row.update(telemetry.comm_metrics(
                plan, spec=self.comm_spec,
                warmup_active=plan != self.ctx.plan.steady()))
            self.history.append(row)
            if step % self.tc.log_every == 0:
                log.info("step %d loss %.4f gnorm %.3f lr %.2e (%.1f ms)",
                         step, loss, row["grad_norm"], row["lr"], row["ms"])
        return params, opt_state, self.history
