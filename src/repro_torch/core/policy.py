"""Step-policy engine: one owner of resolve -> plan-variant cache -> replay
— the JAX package's ``repro/core/policy.py``.

Both ``CommPlan`` consumers — the trainer's step loop and the serving
engine's decode tick — run the same host-side protocol around every step:
resolve the frozen plan variant that runs THIS step (warmup, slot
renegotiation, error escalation), take the step function built for that
variant (plans are frozen and hashable, so each variant is built once),
then give every controller a tick that may demand a bit-exact REPLAY of
the step.

  * :class:`StepController` — the protocol a controller implements:
    ``apply(plan)`` proposes the variant the next step runs, the
    transport's probes (``collectives._slot_probe`` / ``_err_probe``)
    observe the step, and ``finish_step()`` reads them
    (``collectives.drain_probes``: one copy to the host) and returns True
    when the step must be discarded and replayed.
    ``collectives.SlotController`` speaks it.
  * :class:`PolicyEngine` — an ordered controller stack over a base plan
    and a ``build(plan) -> step_fn`` callback: the variant cache and the
    replay loop.
  * :class:`ErrorEscalationController` — per-path relative-error EMAs fed
    by the sampled error probes; a path whose EMA crosses its threshold
    runs its registered fallback codec (``escalate=<fallback>@<thr>``)
    until a ``hold=<N>`` window has passed and the EMA is below the
    threshold again.

Controller order (:func:`default_controllers`): escalation first (which
codec runs), slot renegotiation second (that codec's moved bound).  A
fallback codec has its own ``collectives._slot_key``, so escalation never
touches the watermarks of the codec it replaced.

PyTorch runs eagerly: a "built" variant is a step function closed over
its plan, with nothing compiled.  A replay needs the step's inputs alive;
the consumers make the replay decision before anything is written in
place (``train/trainer.py``: after every hop of the step, before the
optimizer update; ``serve/engine.py``: a replayed tick rewrites the KV
positions its failed run wrote).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Protocol, runtime_checkable

from repro_torch.core import collectives as cc

__all__ = ["StepController", "ErrorEscalationController", "PolicyEngine",
           "default_controllers"]


@runtime_checkable
class StepController(Protocol):
    """One dynamic compression-policy controller, driven between steps.
    A controller whose ``finish_step`` can return True sets
    ``may_replay = True`` (absent reads as True)."""

    #: Whether finish_step may ever demand a replay.
    may_replay: bool = True

    def apply(self, plan):
        """The frozen plan variant the next step should run."""
        ...

    def finish_step(self) -> bool:
        """Read this step's probes and advance the controller.  True: the
        step's decodes may be wrong, discard it and replay."""
        ...

    def metrics(self) -> dict:
        """Cumulative counters in the ``comm/*`` family."""
        ...


class ErrorEscalationController:
    """Error-driven codec escalation (``escalate=<fallback>@<thr>``).

    Per escalating codec identity (:func:`collectives._slot_key`) the
    controller keeps a decaying EMA of the sampled relative quantization
    error and runs::

        NORMAL ──(EMA >= threshold)──> ESCALATED(hold)
           ^                               │
           └──(hold expired AND EMA < threshold)──┘

    In NORMAL the declared codec runs and its probes feed the EMA
    (``DECAY``-weighted toward each step's worst observation).  In
    ESCALATED ``apply`` swaps every path under the key to the fallback
    codec, which probes nothing; the EMA decays (``ema *= DECAY`` a step)
    and the path de-escalates once ``hold`` steps have passed and the EMA
    is below the threshold.  Escalation never replays a step
    (``may_replay = False``).  Flips are ``policy/escalate`` /
    ``policy/deescalate`` events and ``comm/<path>_err_ema`` /
    ``comm/<path>_escalated`` metrics."""

    may_replay = False
    #: ``ema = DECAY*ema + (1-DECAY)*obs`` on observed steps, ``ema *=
    #: DECAY`` on silent (escalated) ones.
    DECAY = 0.75

    def __init__(self, reporter=None):
        self.reporter = reporter
        self._obs: collections.deque = collections.deque()
        self._ema: dict = {}      # key -> relative-error EMA
        self._hold: dict = {}     # escalated key -> hold steps remaining
        self._paths: dict = {}    # key -> set of plan path names (events)
        self.escalations = 0
        self.deescalations = 0
        cc._ERR_CONTROLLERS.add(self)

    # ---- plan resolution ---------------------------------------------------
    def escalated(self, codec) -> bool:
        """Whether ``codec``'s identity currently runs its fallback."""
        return cc._slot_key(codec) in self._hold

    def apply(self, plan):
        """The fallback swap over every codec path of a ``CommPlan``; the
        plan itself when nothing is escalated."""
        from repro_torch.core import registry
        changes = {}
        for f in dataclasses.fields(plan):
            codec = getattr(plan, f.name)
            esc = getattr(codec, "escalate", None)
            if esc is None:
                continue
            key = cc._slot_key(codec)
            self._paths.setdefault(key, set()).add(f.name)
            if key in self._hold:
                changes[f.name] = registry.fallback_codec(esc[0])
        return dataclasses.replace(plan, **changes) if changes else plan

    # ---- the between-steps tick --------------------------------------------
    def finish_step(self) -> bool:
        """Read this step's error probes, advance every key's EMA and flip
        escalation states.  Always False."""
        cc.drain_probes()
        fresh: dict = {}
        while self._obs:
            key, err = self._obs.popleft()
            # several hops share a key within a step: keep the worst
            fresh[key] = max(fresh.get(key, 0.0), err)
        for key in set(self._ema) | set(fresh):
            if key in fresh:
                cur = self._ema.get(key)
                self._ema[key] = fresh[key] if cur is None else \
                    self.DECAY * cur + (1.0 - self.DECAY) * fresh[key]
            else:   # silent step (escalated, or the path did not run)
                self._ema[key] = self.DECAY * self._ema[key]
        for key in list(self._ema):
            fallback, threshold = key.escalate
            ema = self._ema[key]
            if key in self._hold:
                self._hold[key] -= 1
                if self._hold[key] <= 0 and ema < threshold:
                    del self._hold[key]
                    self.deescalations += 1
                    self._event("policy/deescalate", key, err_ema=ema)
            elif ema >= threshold:
                self._hold[key] = int(getattr(key, "hold", 1))
                self.escalations += 1
                self._event("policy/escalate", key, err_ema=ema,
                            fallback=fallback)
        return False

    # ---- telemetry --------------------------------------------------------
    def _event(self, kind, key, **fields) -> None:
        if self.reporter is not None:
            paths = ",".join(sorted(self._paths.get(key, ()))) or "?"
            self.reporter.event(kind, paths=paths, **fields)

    def metrics(self) -> dict:
        """Flip counters plus the per-path EMA and state (``comm/*``)."""
        m = {"comm/escalations": float(self.escalations),
             "comm/deescalations": float(self.deescalations)}
        for key, paths in self._paths.items():
            for path in paths:
                m[f"comm/{path}_err_ema"] = float(self._ema.get(key, 0.0))
                m[f"comm/{path}_escalated"] = \
                    1.0 if key in self._hold else 0.0
        return m


class PolicyEngine:
    """Resolve -> variant cache -> replay for one plan consumer.

    ``build(plan) -> step_fn`` builds the consumer's step for one resolved
    plan variant; the engine caches it by the frozen plan.  Drive a step
    with :meth:`run`::

        engine = PolicyEngine(plan, build,
                              controllers=default_controllers(plan))
        out, plan = engine.run(step, lambda fn: fn(state, batch))

    ``run`` resolves the step's plan (warmup through ``plan.at_step``;
    ``step=None`` skips it, as the decode tick has no step counter),
    calls ``invoke`` with its step function, then ticks every controller,
    replaying while any demands it (the static bound cannot overflow, so
    the loop ends).  When :attr:`replayable` the consumer must keep the
    inputs ``invoke`` reads alive and unwritten until ``run`` returns."""

    def __init__(self, plan, build, *, controllers: tuple = ()):
        self.base_plan = plan
        self._build = build
        self.controllers = tuple(controllers)
        self._fns: dict = {}    # resolved frozen CommPlan -> step fn

    # ---- composition -------------------------------------------------------
    @property
    def replayable(self) -> bool:
        """True when any controller may demand a replay."""
        return any(getattr(c, "may_replay", True)
                   for c in self.controllers)

    def controller(self, cls):
        """The first attached controller of type ``cls``, or None."""
        for c in self.controllers:
            if isinstance(c, cls):
                return c
        return None

    # ---- resolution --------------------------------------------------------
    def plan_at(self, step: int | None = None):
        """The frozen plan variant active at ``step``: the warmup schedule
        first, then every controller's proposal in stack order."""
        plan = self.base_plan if step is None \
            else self.base_plan.at_step(step)
        for c in self.controllers:
            plan = c.apply(plan)
        return plan

    def warmup_active(self, step: int) -> bool:
        """Whether ``step`` still runs the base plan's warmup variant."""
        return self.base_plan.at_step(step) != self.base_plan.steady()

    def fn_for(self, step: int | None = None):
        """``(step_fn, plan)`` of the variant active at ``step``, built on
        first use and cached by the frozen plan after."""
        plan = self.plan_at(step)
        fn = self._fns.get(plan)
        if fn is None:
            fn = self._fns[plan] = self._build(plan)
        return fn, plan

    @property
    def compiled_count(self) -> int:
        """Distinct plan variants built so far (warmup + escalation + the
        negotiation grid: bounded)."""
        return len(self._fns)

    # ---- the step protocol -------------------------------------------------
    def finish_step(self) -> bool:
        """Tick EVERY controller (no short-circuit) and report whether any
        demands a replay."""
        replay = False
        for c in self.controllers:
            replay = bool(c.finish_step()) or replay
        return replay

    def run(self, step: int | None, invoke):
        """One step: resolve, ``invoke(step_fn)``, tick the controllers,
        and replay until every controller is satisfied.  Returns
        ``(outputs, plan)`` of the invocation that stuck."""
        fn, plan = self.fn_for(step)
        out = invoke(fn)
        while self.finish_step():
            # a controller invalidated the step (a negotiated bound
            # overflowed): discard its outputs and replay the resync
            # variant
            out = None
            fn, plan = self.fn_for(step)
            out = invoke(fn)
        return out, plan

    def metrics(self) -> dict:
        """Merged cumulative counters of every attached controller."""
        m: dict = {}
        for c in self.controllers:
            m.update(c.metrics())
        return m


def default_controllers(plan, *, reporter=None,
                        slot_controller=None) -> tuple:
    """The controller stack ``plan`` asks for, in canonical order:
    escalation first, slot renegotiation second.  ``slot_controller``
    pools slot watermarks across engines (the serve engine's hook) and is
    attached even when the plan has no ``slot=auto`` path.  The plan's
    STEADY state decides, so a warmup plan gets the controllers its
    steady plan will need."""
    steady = plan.steady()
    controllers = []
    if steady.has_escalation():
        controllers.append(ErrorEscalationController(reporter=reporter))
    if slot_controller is not None:
        controllers.append(slot_controller)
    elif steady.has_auto_slots():
        controllers.append(cc.SlotController(reporter=reporter))
    return tuple(controllers)
