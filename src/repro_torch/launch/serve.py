"""Serving launcher: build a model (random weights from ``--seed``) and
drive the continuous-batching engine (``repro_torch.serve.engine``) over a
synthetic Poisson arrival stream.

Requests arrive at ``--qps``, are admitted into a fixed ``--max-batch``
slot table, prompts prefill in chunks interleaved with decode ticks, and
every TP hop of the decode path runs through the compressed collectives
selected by ``--comm-spec``.  Runs on the card unless ``--device cpu``.

``--mesh 1,1,P`` serves tensor-parallel over P processes started by
``torchrun`` (NCCL with one card per rank, or gloo with ``--device
cpu``).  Every rank runs the same scheduler on the same arrivals: the
host clock that decides which arrivals have come is rank 0's, broadcast
to the group at every scheduling round, so all ranks take the same steps
and issue the same collectives.  Rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --no-smoke --qps 16 --requests 8 --max-batch 4 --gen 16 \
        --comm-spec taco

``--ckpt DIR`` serves the parameters of the latest checkpoint in DIR (a
trainer checkpoint of either package, or a bare parameter tree) in place
of the seeded ones.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core import collectives as cc
from repro_torch.core.parallel import ParallelCtx, init_tp_group
from repro_torch.launch._args import (DEFAULT_SPEC, add_policy_alias,
                                      resolve_comm_spec)
from repro_torch.launch.mesh import parse_mesh
from repro_torch.core.registry import from_spec, to_spec
from repro_torch.models.layers import tree_map
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine

def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (CPU-sized); --no-smoke for full")
    ap.add_argument("--mesh", default="1,1,1",
                    help="pod,data,model; 1,1,P serves TP over P processes "
                         "(torchrun)")
    ap.add_argument("--comm-spec", default=None, dest="comm_spec",
                    help="compression plan spec or alias (default: "
                         f"{DEFAULT_SPEC})")
    add_policy_alias(ap)
    ap.add_argument("--qps", type=float, default=16.0,
                    help="synthetic Poisson arrival rate (requests/s)")
    ap.add_argument("--requests", type=int, default=8,
                    help="total synthetic requests to serve")
    ap.add_argument("--max-batch", type=int, default=4, dest="max_batch",
                    help="slot-table rows (in-flight decode batch)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16,
                    help="new tokens per request")
    ap.add_argument("--max-len", type=int, default=64, dest="max_len")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the request stream")
    ap.add_argument("--ckpt", default=None,
                    help="restore params from a checkpoint dir")
    ap.add_argument("--kv", default="auto", choices=["auto", "pad_shard"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_engine(args, group=None):
    """(engine, cfg) for parsed launcher args.  The TP group is ``group``
    when given (its size must be the mesh's model axis), else joined from
    the ``torchrun`` environment when the mesh's model axis is > 1, else
    none."""
    pod, data, tp = parse_mesh(args.mesh)
    if pod * data != 1:
        raise NotImplementedError(
            f"mesh {args.mesh}: serving over pod and data axes is not "
            "ported, and the JAX package cannot do it either: its engine "
            "places each request's one-row prefill cache with the "
            "dp-sharded cache specs (src/repro/serve/engine.py, lines "
            "270-271), and a batch of 1 does not split over data > 1 "
            "(ValueError at --mesh 1,2,2); the port serves tensor parallel "
            "only (--mesh 1,1,P)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if group is None and tp > 1:
        group = init_tp_group(args.device or "cuda")
    comm_plan = from_spec(resolve_comm_spec(args))
    ctx = ParallelCtx(plan=comm_plan, group=group)
    if ctx.tp_size != tp:
        raise ValueError(f"mesh {args.mesh} wants a TP group of {tp}, the "
                         f"process group has {ctx.tp_size} ranks")
    plan = make_plan(cfg, tp, 1, remat=False, kv_strategy=args.kv)
    model = Model(cfg, plan, device=args.device, tp_rank=ctx.tp_rank)
    if ctx.tp_rank == 0:
        print(f"serving with comm spec: {to_spec(comm_plan)}")
    params = model.init(args.seed)
    if args.ckpt:
        params = restore_params(args.ckpt, model, params,
                                verbose=ctx.tp_rank == 0)
    return make_engine(args, model, ctx, params), cfg


def make_engine(args, model, ctx, params):
    """The launcher's ``ServeEngine`` for ``model`` and its ``params``:
    the slot table, cache length and prefill buckets of ``args``."""
    max_len = max(args.max_len, args.prompt_len + args.gen + 1)
    buckets = tuple(sorted({min(8, args.prompt_len),
                            min(32, max(args.prompt_len, 1))}))
    return ServeEngine(model, ctx, params, max_batch=args.max_batch,
                       max_len=max_len, prefill_buckets=buckets,
                       device=args.device)


def restore_params(ckpt_dir: str, model, params, verbose: bool = True):
    """This rank's shards of the parameters in the latest checkpoint of
    ``ckpt_dir``: a bare parameter tree, or the ``['params']`` subtree of a
    trainer checkpoint (the JAX package's launcher means to unwrap it,
    but restores against the bare tree and fails on a trainer checkpoint:
    ROADMAP queue 3).  Prints the spec the checkpoint was trained with and
    the step."""
    trained_spec = ck.read_comm_spec(ckpt_dir)
    if trained_spec is not None and verbose:
        # serving may legitimately use another decode plan than the one
        # trained with: surface it rather than fail
        print(f"checkpoint was trained with comm spec: {trained_spec}")
    prefix = "['params']" if any(k.startswith("['params']")
                                 for k in ck.leaf_keys(ckpt_dir)) else ""
    template = tree_map(lambda s, p: torch.empty(
        s.shape, dtype=p.dtype, device="meta"), model.specs(), params)
    glob, step = ck.restore(ckpt_dir, template, device="cpu", prefix=prefix)
    if verbose:
        print(f"restored checkpoint step {step}")
    return model.cut_params(glob)


def drive(eng, args, cfg) -> tuple[dict, float]:
    """Serve ``args.requests`` Poisson arrivals to completion; returns
    (summary, wall seconds)."""
    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.qps, args.requests))
    pending = collections.deque(
        (float(t),
         rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32))
        for t in arrivals)
    t0 = time.monotonic()
    while pending or not eng.sched.idle():
        now = _group_clock(time.monotonic() - t0, eng)
        while pending and pending[0][0] <= now:
            t_arr, prompt = pending.popleft()
            eng.submit(prompt, max_new=args.gen, now=t_arr)
        # the engine runs on its own real clock (no explicit now=), so
        # first-token stamps land after the prefill device work
        if not eng.tick() and pending:
            time.sleep(max(0.0, pending[0][0] - now))
    return eng.summary(), time.monotonic() - t0


def _group_clock(now: float, eng) -> float:
    """Rank 0's ``now``, on every rank of the engine's TP group."""
    if not cc.moves(eng.ctx.comm):
        return now
    t = torch.tensor([now], dtype=torch.float64, device=eng.device)
    dist.broadcast(t, dist.get_global_rank(eng.ctx.group, 0),
                   group=eng.ctx.group)
    return float(t[0])


def main(argv=None) -> dict:
    args = parse_args(argv)
    eng, cfg = build_engine(args)
    try:
        s, wall = drive(eng, args, cfg)
    finally:
        if eng.ctx.group is not None:
            dist.destroy_process_group()
    if eng.ctx.tp_rank != 0:
        return s
    for row in eng.reporter.of_kind("serve/request"):
        print("request rid={rid} prompt={prompt_len} new={new_tokens} "
              "queue={queue_s:.4f}s ttft={ttft_s:.4f}s "
              "decode={ms:.2f}ms/tok wire={wire_bytes_per_tok:.0f}B/tok"
              .format(ms=row["decode_s_per_tok"] * 1e3
                      if row["decode_s_per_tok"] else float("nan"), **row))
    toks = s.get("total_new_tokens", 0)
    print(f"served {s['requests']} requests / {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s), "
          f"p50 {s.get('decode_ms_per_tok_p50', float('nan')):.2f} "
          f"p99 {s.get('decode_ms_per_tok_p99', float('nan')):.2f} ms/tok")
    print("serving done")
    return s


if __name__ == "__main__":
    main()
