"""Request scheduler: arrival queue, admission, continuous batching.

The scheduler owns the request LIFECYCLE; the engine owns the device
steps.  Requests move through::

    QUEUED --admit--> PREFILL --install--> DECODE --retire--> DONE
       (arrival queue,  (chunked prefill     (slot table,      (slot freed
        FIFO)            ticks, engine)       per-token ticks)  via pager)

Admission is gated by the :class:`~repro_torch.serve.kv_pager.KVPager`: a
request is admitted when a cache slot AND enough KV pages for its prompt
exist (evicting retired-but-cached slots LRU-first).  Finished sequences
retire and new requests join the in-flight batch BETWEEN decode
steps — the slot table is fixed-shape (``max_batch`` rows, inactive rows
run masked garbage), so the decode step's shapes never change with
churn.

Every request carries its own latency accounting (queue wait, prefill
time, per-token decode times) — the per-request telemetry stream the
engine emits through ``repro_torch.core.telemetry``.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.serve.kv_pager import KVPager

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"


@dataclasses.dataclass
class Request:
    """One generation request and its telemetry."""

    rid: int
    prompt: np.ndarray                  # (L,) int32 token ids
    max_new: int = 16
    eos: int | None = None              # stop token (None = length only)
    arrival: float = 0.0                # engine-clock submit time (s)

    state: str = QUEUED
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)   # generated ids
    prefill_done: int = 0               # prompt tokens already prefilled

    # latency accounting (engine clock, seconds)
    t_admit: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None
    decode_ticks: list = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def finished(self) -> bool:
        if len(self.tokens) >= self.max_new:
            return True
        return bool(self.eos is not None and self.tokens
                    and self.tokens[-1] == self.eos)

    # ---- derived telemetry -------------------------------------------------
    def latency_row(self) -> dict:
        """The per-request telemetry record (serve/request rows)."""
        n = len(self.tokens)
        queue_s = (self.t_admit - self.arrival
                   if self.t_admit is not None else None)
        prefill_s = (self.t_first_token - self.t_admit
                     if None not in (self.t_first_token, self.t_admit)
                     else None)
        per_tok = (float(np.mean(self.decode_ticks))
                   if self.decode_ticks else None)
        return {"rid": self.rid, "prompt_len": self.prompt_len,
                "new_tokens": n, "queue_s": queue_s,
                "prefill_s": prefill_s, "decode_s_per_tok": per_tok,
                "ttft_s": (self.t_first_token - self.arrival
                           if self.t_first_token is not None else None),
                "total_s": (self.t_done - self.arrival
                            if self.t_done is not None else None)}


class Scheduler:
    """FIFO admission over a fixed-shape slot table."""

    def __init__(self, pager: KVPager):
        self.pager = pager
        self.queue: collections.deque[Request] = collections.deque()
        self.slot_req: list[Request | None] = [None] * pager.n_slots
        self.done: list[Request] = []
        self._next_rid = 0

    @property
    def max_batch(self) -> int:
        return self.pager.n_slots

    # ---- arrivals ----------------------------------------------------------
    def submit(self, prompt, max_new: int = 16, eos: int | None = None,
               arrival: float = 0.0) -> Request:
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new=int(max_new), eos=eos, arrival=float(arrival))
        self._next_rid += 1
        self.queue.append(req)
        return req

    # ---- admission ---------------------------------------------------------
    def admit(self, now: float = 0.0, limit: int | None = None) -> list:
        """Admit queued requests (FIFO) while the pager grants slot +
        pages.  Returns the newly admitted requests (state PREFILL) —
        the engine starts their chunked prefill."""
        admitted = []
        while self.queue and (limit is None or len(admitted) < limit):
            req = self.queue[0]
            slot = self.pager.alloc(req.rid, req.prompt_len)
            if slot is None:
                break                    # head-of-line blocks (FIFO)
            self.queue.popleft()
            req.state, req.slot, req.t_admit = PREFILL, slot, float(now)
            self.slot_req[slot] = req
            admitted.append(req)
        return admitted

    # ---- retirement --------------------------------------------------------
    def retire(self, req: Request, now: float = 0.0,
               keep_cached: bool = False) -> None:
        """Explicitly retire a finished (or cancelled) request, freeing
        its slot for the next admission wave."""
        if req.slot is not None:
            self.pager.retire(req.slot, keep_cached=keep_cached)
            self.slot_req[req.slot] = None
        req.state, req.t_done, req.slot = DONE, float(now), None
        self.done.append(req)

    def retire_finished(self, now: float = 0.0) -> list:
        out = []
        for req in list(self.slot_req):
            if req is not None and req.state == DECODE and req.finished():
                self.retire(req, now=now)
                out.append(req)
        return out

    # ---- views -------------------------------------------------------------
    def decoding(self) -> list:
        return [r for r in self.slot_req
                if r is not None and r.state == DECODE]

    def prefilling(self) -> list:
        return [r for r in self.slot_req
                if r is not None and r.state == PREFILL]

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)

    def stats(self) -> dict:
        return dict(self.pager.stats(), queued=len(self.queue),
                    decoding=len(self.decoding()),
                    prefilling=len(self.prefilling()),
                    done=len(self.done))
