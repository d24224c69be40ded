"""Observability: the per-step ``comm/*`` wire accounting shared by the
trainer and the serving engine (:func:`comm_metrics`), the event/counter
:class:`Reporter` and the nearest-rank :func:`percentile` — the JAX
package's ``core/telemetry.py``.  Everything is host-side Python on
static plan data, apart from the one cached probe encode behind
:func:`achieved_probe_ratio`."""
from __future__ import annotations

import collections
import logging
import math
import time

_PROBE_RATIO_CACHE: dict = {}


def achieved_probe_ratio(codec) -> float:
    """Achieved / slot byte fraction of ``codec`` on an all-zero probe
    slot: the floor of its variable wire layout.  One encode on the CPU,
    cached per codec identity (negotiated variants share the entry)."""
    import torch

    from repro_torch.core import collectives as cc
    key = cc._slot_key(codec)
    cached = _PROBE_RATIO_CACHE.get(key)
    if cached is None:
        n = 4 * key.granule
        probe = torch.zeros((1, n), dtype=torch.bfloat16)
        ach = cc.achieved_slot_bytes(key, probe)
        slot = cc.wire_slot_bytes(key, n)
        cached = float(ach[0]) / float(slot)
        _PROBE_RATIO_CACHE[key] = cached
    return cached


def clear_probe_cache() -> None:
    """Drop every cached :func:`achieved_probe_ratio` entry."""
    _PROBE_RATIO_CACHE.clear()


def comm_metrics(plan, *, spec: str | None = None,
                 warmup_active: bool | None = None) -> dict:
    """Per-path wire telemetry for the plan that ran a step (static apart
    from the cached floor probe): ``comm/spec``, ``comm/warmup_active``,
    ``comm/<path>_bytes_per_elem`` for every path, ``comm/<path>_chunks``
    on a ring, ``comm/<path>_wire_variable`` and
    ``comm/<path>_achieved_floor_ratio`` on a variable layout,
    ``comm/<path>_slot_auto`` and ``comm/<path>_negotiated_bytes`` under
    ``slot=auto``, and ``comm/<path>_escalate_threshold`` under
    ``escalate=`` — the JAX package's key set."""
    m: dict = {}
    if spec is not None:
        m["comm/spec"] = spec
    if warmup_active is not None:
        m["comm/warmup_active"] = 1.0 if warmup_active else 0.0
    for path, bpe in plan.wire_bytes_per_element().items():
        m[f"comm/{path}_bytes_per_elem"] = bpe
    for path, nc in plan.wire_chunks().items():
        if nc != 1:
            m[f"comm/{path}_chunks"] = nc
    for path, var in plan.wire_variable().items():
        if var:
            m[f"comm/{path}_wire_variable"] = 1.0
            m[f"comm/{path}_achieved_floor_ratio"] = \
                achieved_probe_ratio(getattr(plan, path))
    for path, mode in plan.slot_modes().items():
        if mode == "auto":
            # the bytes/elem the negotiated bound moves (the slot bound
            # while bootstrapping or resyncing: moved_frac unset)
            frac = getattr(getattr(plan, path), "moved_frac", None)
            if frac is None:
                worst = 1.0
            elif isinstance(frac, (int, float)):
                worst = float(frac)
            else:
                worst = max(frac)
            m[f"comm/{path}_slot_auto"] = 1.0
            m[f"comm/{path}_negotiated_bytes"] = \
                m[f"comm/{path}_bytes_per_elem"] * worst
    for path, esc in plan.escalation_modes().items():
        if esc is not None:
            m[f"comm/{path}_escalate_threshold"] = float(esc[1])
    return m


class Reporter:
    """Append-only event/counter sink.

    ``event(kind, **fields)`` records one row (a plain dict);
    ``count(name)`` bumps a cumulative counter.  ``maxlen`` turns the row
    store into a ring buffer keeping only the newest rows."""

    def __init__(self, log: logging.Logger | None = None, *,
                 maxlen: int | None = None):
        if maxlen is not None and maxlen < 1:
            raise ValueError(f"Reporter maxlen must be >= 1, got {maxlen}")
        self.rows = [] if maxlen is None \
            else collections.deque(maxlen=maxlen)
        self.counters: dict[str, float] = {}
        self._log = log

    @property
    def maxlen(self) -> int | None:
        return getattr(self.rows, "maxlen", None)

    def event(self, kind: str, **fields) -> dict:
        row = {"kind": kind, "t": time.monotonic(), **fields}
        self.rows.append(row)
        if self._log is not None:
            self._log.debug("%s %s", kind, fields)
        return row

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def of_kind(self, kind: str) -> list[dict]:
        return [r for r in self.rows if r["kind"] == kind]

    def drain(self) -> list[dict]:
        rows = list(self.rows)
        self.rows.clear()
        return rows


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0,100]) of a non-empty sequence."""
    values = list(values)
    if not values:
        raise ValueError("percentile of empty sequence")
    xs = sorted(values)
    rank = max(1, math.ceil(len(xs) * q / 100.0))
    return float(xs[min(rank, len(xs)) - 1])
