"""What a traced run records, and the record the per-layer readers read.

The benchmark's own spans (host clock, ``time.time_ns``, the clock the
profiler stamps its events in) are taken around its calls into the
program: ``data`` (the batch made and placed), ``policy.run`` (the
policy engine's attempt: every hop of the forward and the backward),
``apply`` (the optimizer update) and ``step`` (one whole trainer step,
which ends when the step's loss has reached the host).  The device's
activities come from a profiler session that traces the device only (a
host trace would add minutes of events and draw each ``nccl:*`` range
over the copy it encloses).

Kernel classes, by name: TACO's kernels by their ``__global__`` names
(:data:`TACO`), GEMMs by cuBLAS's and CUTLASS's name marks
(:data:`GEMM`); copies and fills (``Memcpy``, ``Memset``) are device
activity but no kernel; every other kernel is elementwise.
"""
from __future__ import annotations

import contextlib
import re
import time

#: the port's TACO kernels (K1-K7), by their ``__global__`` names
TACO = re.compile(r"\b(compress_blocks|compress_wire|decompress_blocks|"
                  r"decompress_reduce|decompress_wire|decompress_reduce_wire|"
                  r"compress_blocks_butterfly)_kernel\b")
#: GEMM kernels: cuBLAS (``gemm``, ``gemv``, ``nvjet``, ``xmma``,
#: ``splitKreduce``), CUTLASS (``cutlass``)
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitkreduce", re.I)
#: device activities that are no kernel
COPY = re.compile(r"^(Memcpy|Memset)")


def kind(name: str) -> str:
    """``"taco"``, ``"gemm"``, ``"copy"`` or ``"elementwise"``."""
    if COPY.search(name):
        return "copy"
    if TACO.search(name):
        return "taco"
    if GEMM.search(name):
        return "gemm"
    return "elementwise"


class Spans:
    """Host spans ``(label, start_ns, end_ns)``, kept in memory."""

    def __init__(self):
        self.items: list = []

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((label, t0, time.time_ns()))

    def wrap(self, label: str, fn):
        """``fn`` with every call recorded as a span."""
        def wrapped(*args, **kwargs):
            with self.span(label):
                return fn(*args, **kwargs)
        return wrapped

    def label_at(self, t: int) -> str:
        """The innermost span covering time ``t``, or ``"between steps"``
        (the benchmark's loop)."""
        best = None
        for label, t0, t1 in self.items:
            if t0 <= t < t1 and (best is None or t1 - t0 < best[1]):
                best = (label, t1 - t0)
        if best is None:
            return "between steps"
        return best[0] if best[0] != "step" else "step (trainer)"


class DeviceTrace:
    """A profiler session over the device only; ``events`` after
    :meth:`stop`: ``(name, start_ns, end_ns)`` of every device activity
    (none without a card: the tests' CPU runs)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA]) \
            if torch.cuda.is_available() else None
        self.events: list = []

    def start(self):
        if self.prof is not None:
            self.prof.start()

    def stop(self):
        import torch
        from torch.autograd import DeviceType
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.prof.stop()
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                self.events.append((e.name(), e.start_ns(), e.end_ns()))
        self.events.sort(key=lambda e: e[1])


def busy_intervals(events) -> list:
    """The union of the events' intervals, merged, in time order."""
    out: list = []
    for _, t0, t1 in events:
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1][1] = t1
        else:
            out.append([t0, t1])
    return out


def record(cell, spans: Spans, steps: list, window: tuple,
           events: list) -> dict:
    """What the per-layer readers read: the cell's configuration and
    traffic, the window ``(start_ns, end_ns)``, each step's ``(start_ns,
    end_ns)``, the device events and their busy union, clipped to the
    window."""
    w0, w1 = window
    events = [(n, max(a, w0), min(b, w1)) for n, a, b in events
              if b > w0 and a < w1]
    busy = busy_intervals(events)
    return {"config": cell["config"], "traffic": cell["traffic"],
            "window": window, "window_s": (w1 - w0) / 1e9, "steps": steps,
            "events": events,
            "busy": busy, "spans": spans}


def kind_seconds(rec, which: str) -> float:
    """Device seconds of the window's kernels of one :func:`kind`."""
    return sum(b - a for n, a, b in rec["events"] if kind(n) == which) / 1e9


def idle_gaps(rec) -> list:
    """``(start_ns, seconds)`` of every idle stretch of the window."""
    w0, w1 = rec["window"]
    edges = [w0] + [t for iv in rec["busy"] for t in iv] + [w1]
    return [(a, (b - a) / 1e9) for a, b in zip(edges[0::2], edges[1::2])
            if b > a]


def breakdown(rec) -> dict:
    """The ten device operations that took most time (summed by name) and
    the ten longest idle gaps, each labelled by the benchmark's span that
    covered its start."""
    by_name: dict = {}
    for n, a, b in rec["events"]:
        by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(rec), key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:200], t / 1e9] for n, t in ops],
            "idle_gaps": [[rec["spans"].label_at(a), s] for a, s in gaps]}


def busy_s(rec) -> float:
    return sum(b - a for a, b in rec["busy"]) / 1e9
