"""Fault-tolerance runtime: step watchdog, retry-from-checkpoint policy and
failure injection — the JAX package's ``repro/runtime/
fault_tolerance.py``, kept as the port's own copy.

  * ``StepWatchdog`` — per-step wall-clock monitor; steps exceeding
    ``straggler_factor`` x the running median are logged as stragglers;
  * ``RetryPolicy`` — how often the trainer restores the latest checkpoint
    and replays after a failed step (the data pipeline being a pure
    function of step makes the replay bitwise);
  * ``FailureInjector`` — deterministic failures for restart tests.
"""
from __future__ import annotations

import dataclasses
import logging
import statistics
import time

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class StepWatchdog:
    straggler_factor: float = 3.0
    window: int = 50
    _times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def observe(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self._times) >= 5:
            med = statistics.median(self._times[-self.window:])
            if seconds > self.straggler_factor * med:
                self.stragglers += 1
                is_straggler = True
                log.warning("straggler step: %.3fs vs median %.3fs",
                            seconds, med)
        self._times.append(seconds)
        if len(self._times) > 2 * self.window:
            del self._times[:self.window]
        return is_straggler


class FailureInjector:
    """Deterministic failure injection for restart tests."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class RetryPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.0
    restarts: int = 0

    def should_retry(self, exc: Exception) -> bool:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            return False
        log.warning("step failed (%s); restart %d/%d",
                    exc, self.restarts, self.max_restarts)
        if self.backoff_s:
            time.sleep(self.backoff_s)
        return True
