"""Continuous-batching serving engine with prefill/decode disaggregation.

The engine turns the single-step decode path (``serve_step.py``) into a
request-serving system:

  * **decode tick** — the full fixed-shape slot table (``max_batch`` rows)
    advances one token with a PER-SLOT position vector; inactive rows run
    masked garbage.  Every TP hop goes through the compressed collectives
    on ``ctx`` (``tp_g``), so the codec spec is on the decode hot path.
  * **prefill** — a prompt chunk (at most one bucket of tokens per engine
    tick) runs through ``decode_forward`` token by token on a private
    one-row cache.  The JAX package scans a padded bucket and masks the
    padding steps; the port loops over the valid tokens only, which
    writes the same cache.  Long prompts advance one chunk per tick,
    interleaved with decode ticks.
  * **install** — a finished prefill's one-row cache is copied into its
    slot-table row (in place), every leaf of it (an encoder-decoder's
    cross-attention ``xk`` / ``xv`` too), and the slot joins the next
    decode tick.

Retirement, admission (the :class:`~repro_torch.serve.kv_pager.KVPager`)
and prefill advancement happen on the host between device steps.

The decode tick runs through a ``core/policy.py`` ``PolicyEngine``, as
the JAX engine's does: ``slot=auto`` TP paths renegotiate the decode wire
bound between ticks (pass a shared ``slot_controller=`` to pool
watermarks across engines), ``escalate=`` paths swap to their fallback
codec on error spikes, and a tick whose negotiated bound overflowed is
replayed at the static bound.  The replay needs no copy of the KV cache:
the tick writes each layer's k/v at every slot's position before that
layer reads the cache, so the replay overwrites exactly the positions
the failed run wrote.  That does not hold for a recurrent state (RWKV's
token shifts and ``s``, the SSM's ``conv`` and ``h``): the tick reads
the state and overwrites all of it, so a replay from the failed run's
state would apply the recurrence twice.  So when a replay is possible
the engine keeps a copy of the state leaves before the tick and puts it
back before a replay, which then starts from the state the failed run
read, as the JAX package's functional decode does.  Prefill runs the
base plan (the static bound, never negotiated); its probes feed the
controllers too.  PyTorch runs eagerly, so a plan variant is a decode
function closed over its plan, with nothing compiled, and the summary has
no retrace counter.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import collectives as cc
from repro_torch.core import policy, telemetry
from repro_torch.models.model import resolve_device
from repro_torch.serve import serve_step as ss
from repro_torch.serve.kv_pager import KVPager
from repro_torch.serve.scheduler import DECODE, Request, Scheduler

DEFAULT_BUCKETS = (8, 32)

#: Ring-buffer depth of the engine's default Reporter.
REPORTER_MAXLEN = 4096


def _tp_hops_per_token(cfg) -> int:
    """Compressed tp_g AllReduce hops one decode token crosses (embed +
    two per layer, three with an encoder-decoder's cross-attention; see
    serve_step._decode_block)."""
    per_layer = 3 if cfg.family == "encdec" else 2
    return cfg.n_layers * per_layer + 1


class ServeEngine:
    """Continuous-batching engine over a fixed-shape slot table.  Runs on
    the model's device, which must be ``device`` (CUDA unless "cpu")."""

    def __init__(self, model, ctx, params, *, max_batch: int = 4,
                 max_len: int = 64, block: int = 16,
                 total_blocks: int | None = None,
                 prefill_buckets=DEFAULT_BUCKETS,
                 collect_logits: bool = False, reporter=None, device=None,
                 slot_controller=None):
        dev = resolve_device(device)
        if dev.type != model.device.type:
            raise ValueError(f"engine device {dev} but model on "
                             f"{model.device}")
        self.model, self.ctx, self.params = model, ctx, params
        self.device = model.device
        self.max_batch, self.max_len = int(max_batch), int(max_len)
        self.buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        if not self.buckets:
            raise ValueError("need at least one prefill bucket length")
        self.collect_logits = collect_logits
        self.reporter = reporter if reporter is not None \
            else telemetry.Reporter(maxlen=REPORTER_MAXLEN)
        self.policy = policy.PolicyEngine(
            ctx.plan, self._build_decode_for,
            controllers=policy.default_controllers(
                ctx.plan, reporter=self.reporter,
                slot_controller=slot_controller))
        self.pager = KVPager(self.max_batch, self.max_len, block=block,
                             total_blocks=total_blocks)
        self.sched = Scheduler(self.pager)
        self.cache = ss.init_cache(model, self.max_batch, self.max_len)
        # host-side slot table: current token + per-slot position
        self.slot_tok = np.zeros((self.max_batch, 1), np.int32)
        self.slot_pos = np.zeros((self.max_batch,), np.int32)
        self.ticks = 0
        self.decode_steps = 0
        self.prefill_steps = 0      # decode_forward calls made by prefill
        self.policy.fn_for()        # the decode function of the base plan
        self._t0 = time.monotonic()

    # ---- the decode step of one plan variant --------------------------------
    def _build_decode_for(self, plan):
        """The engine's build callback: the decode step of one resolved
        plan variant (the base plan, a negotiated bound, or a fallback
        codec), ``fn(tok, pos)`` on the slot table's cache."""
        ctx = self.ctx if plan == self.ctx.plan else \
            dataclasses.replace(self.ctx, plan=plan)

        def step(tok, pos):
            return ss.decode_forward(self.params, tok, self.cache, pos,
                                     self.model, ctx,
                                     return_logits=self.collect_logits)
        return step

    @property
    def slots(self):
        """The engine's ``SlotController`` (under ``slot=auto``, or the one
        passed in), else None."""
        return self.policy.controller(cc.SlotController)

    # ---- request API -------------------------------------------------------
    def submit(self, prompt, max_new: int = 16, eos: int | None = None,
               now: float | None = None) -> Request:
        return self.sched.submit(prompt, max_new=max_new, eos=eos,
                                 arrival=self._now(now))

    def _now(self, now: float | None) -> float:
        return time.monotonic() - self._t0 if now is None else float(now)

    # ---- prefill advancement ----------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _advance_prefill(self, req: Request, now: float | None) -> None:
        """Advance ``req`` by one prefill chunk.  ``now`` None means the
        engine runs on its real clock: the first-token stamp is then taken
        after the device work."""
        if not hasattr(req, "_pcache"):
            req._pcache = ss.init_cache(self.model, 1, self.max_len)
        remaining = req.prompt_len - req.prefill_done
        chunk = min(remaining, self._bucket_for(remaining))
        toks = torch.as_tensor(
            req.prompt[req.prefill_done:req.prefill_done + chunk],
            dtype=torch.long, device=self.device)
        nxt = None
        for t in range(chunk):
            nxt = ss.decode_forward(self.params, toks[t].reshape(1, 1),
                                    req._pcache, req.prefill_done + t,
                                    self.model, self.ctx)
            self.prefill_steps += 1
        req.prefill_done += chunk
        if req.prefill_done >= req.prompt_len:
            # splice the prefilled row into the slot table (in place); the
            # slot joins THIS tick's decode step
            for seg, sub in zip(self.cache, req._pcache):
                for k in seg:
                    seg[k][:, req.slot] = sub[k][:, 0]
            del req._pcache
            first = int(nxt[0, 0])
            req.tokens.append(first)
            req.t_first_token = self._now(now)
            req.state = DECODE
            self.slot_tok[req.slot, 0] = first
            self.slot_pos[req.slot] = req.prompt_len

    # ---- decode tick -------------------------------------------------------
    def _decode_tick(self, now: float) -> None:
        tok = torch.as_tensor(self.slot_tok, dtype=torch.long,
                              device=self.device)
        pos = torch.as_tensor(self.slot_pos, dtype=torch.long,
                              device=self.device)
        t0 = time.perf_counter()
        kept = self._state_leaves(copy=True) if self.policy.replayable \
            else []
        attempts = 0

        def invoke(fn):
            nonlocal attempts
            if attempts:                 # a replay: restore the read state
                for leaf, old in zip(self._state_leaves(), kept):
                    leaf.copy_(old)
            attempts += 1
            return fn(tok, pos)
        # resolve this tick's plan, run it, tick the controllers, and
        # replay a tick whose negotiated bound overflowed
        out, _ = self.policy.run(None, invoke)
        nxt, logits = out if self.collect_logits else (out, None)
        nxt = nxt.cpu().numpy()                 # waits for the device
        dt = time.perf_counter() - t0
        if logits is not None:
            logits = logits.cpu().numpy()
        self.decode_steps += 1
        for req in self.sched.decoding():
            s = req.slot
            tok_id = int(nxt[s, 0])
            req.tokens.append(tok_id)
            req.decode_ticks.append(dt)
            if logits is not None:
                req.logit_rows = getattr(req, "logit_rows", [])
                req.logit_rows.append(logits[s])
            self.slot_tok[s, 0] = tok_id
            # this tick wrote kv at position pos: the row now holds pos+1
            # tokens; the NEXT tick needs position pos+1 < max_len
            used = int(self.slot_pos[s]) + 1
            if self.pager.extend(s, used) and used < self.max_len:
                self.slot_pos[s] += 1
            else:                                 # out of cache: truncate
                req.max_new = len(req.tokens)
        self.reporter.count("serve/decode_ticks")

    def extract_slot(self, slot: int) -> list:
        """A one-row copy of slot ``slot``'s rows of the slot table's cache
        (per segment, every leaf; tests and prefix reuse)."""
        return [{k: v[:, slot:slot + 1].clone() for k, v in seg.items()}
                for seg in self.cache]

    def _state_leaves(self, copy: bool = False) -> list:
        """The slot table's recurrent state leaves (none for attention
        caches), or copies of them."""
        return [leaf.clone() if copy else leaf for seg in self.cache
                for k, leaf in sorted(seg.items()) if k in ss.STATE_LEAVES]

    # ---- the engine loop ---------------------------------------------------
    def tick(self, now: float | None = None) -> bool:
        """One scheduling round: retire -> admit -> prefill -> decode.
        Returns False when there was nothing to do (engine idle)."""
        explicit = now is not None
        now = self._now(now)
        self.ticks += 1
        for req in self.sched.retire_finished(now=now):
            self._emit_request_row(req)
        self.sched.admit(now=now)
        for req in self.sched.prefilling():
            self._advance_prefill(req, now if explicit else None)
        for req in self.sched.retire_finished(now=now):
            self._emit_request_row(req)    # max_new == 1: done at prefill
        if self.sched.decoding():
            self._decode_tick(now)
            return True
        return bool(self.sched.prefilling() or self.sched.queue)

    def run_until_drained(self, max_ticks: int = 100_000) -> list[Request]:
        """Drive ticks until queue + slot table are empty; returns the
        retired requests in completion order."""
        for _ in range(max_ticks):
            if self.sched.idle():
                break
            self.tick()
        else:
            raise RuntimeError("engine failed to drain "
                               f"within {max_ticks} ticks")
        return self.sched.done

    # ---- telemetry ---------------------------------------------------------
    def _emit_request_row(self, req: Request) -> None:
        row = req.latency_row()
        bpe = self.ctx.plan.wire_bytes_per_element()["tp_fwd"]
        hops = _tp_hops_per_token(self.model.cfg)
        row["wire_bytes_per_tok"] = bpe * self.model.cfg.d_model * hops
        row["wire_bytes"] = row["wire_bytes_per_tok"] * row["new_tokens"]
        self.reporter.event("serve/request", **row)

    def summary(self) -> dict:
        rows = self.reporter.of_kind("serve/request")
        out = dict(self.sched.stats(), ticks=self.ticks,
                   decode_steps=self.decode_steps,
                   prefill_steps=self.prefill_steps, requests=len(rows))
        out.update(telemetry.comm_metrics(self.policy.plan_at(), spec=None))
        out.update(self.policy.metrics())
        if rows:
            per_tok = [r["decode_s_per_tok"] for r in rows
                       if r["decode_s_per_tok"] is not None]
            if per_tok:
                out["decode_ms_per_tok_p50"] = \
                    telemetry.percentile(per_tok, 50) * 1e3
                out["decode_ms_per_tok_p99"] = \
                    telemetry.percentile(per_tok, 99) * 1e3
            ttft = [r["ttft_s"] for r in rows if r["ttft_s"] is not None]
            if ttft:
                out["ttft_ms_p50"] = telemetry.percentile(ttft, 50) * 1e3
                out["ttft_ms_p99"] = telemetry.percentile(ttft, 99) * 1e3
            out["total_new_tokens"] = sum(r["new_tokens"] for r in rows)
        return out
