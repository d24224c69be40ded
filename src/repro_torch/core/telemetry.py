"""Observability: the trainer's per-step ``comm/*`` wire accounting
(:func:`comm_metrics`), and for the serving engine the event/counter
:class:`Reporter` and the nearest-rank :func:`percentile` (copies of the
JAX package's ``core/telemetry.py`` pieces the port's paths use)."""
from __future__ import annotations

import collections
import logging
import math
import time


def comm_metrics(plan, *, spec: str | None = None,
                 warmup_active: bool | None = None) -> dict:
    """Per-path wire telemetry for the plan that ran a step (static, no
    device work): ``comm/spec``, ``comm/warmup_active``,
    ``comm/<path>_bytes_per_elem`` for every path and
    ``comm/<path>_chunks`` for every path whose codec runs the chunked
    ring — the JAX package's key set for the codecs the port has (its
    variable-layout, ``slot=auto`` and escalation families need codecs
    the port's plans cannot carry yet)."""
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
