"""Training launcher: build a model (random weights from ``--seed``) and run
``--steps`` Megatron-SP training steps on synthetic data, every TP hop
through the compressed collectives selected by ``--comm-spec``.  Runs on
the card unless ``--device cpu``.  Prints one line per step and a summary
(rank 0 only).

``--mesh pod,data,model`` runs over pod x data x model processes, one per
rank, started by ``torchrun --nproc-per-node pod*data*model`` (rank and
world size from its environment): NCCL with one card per rank, or gloo
with ``--device cpu``.  The model axis is tensor parallelism; weights are
fsdp-sharded over pod x data and the batch is split over it, and every
weight gradient crosses the data axes through the ``grad_rs=`` codec
(``launch/mesh.py``).  Every rank draws the same weights and the same
global batches and keeps its shards.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --no-smoke --steps 8 --seq 2048 --batch 4 --comm-spec taco

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --smoke --steps 3 --seq 32 --batch 2 --comm-spec tp=taco,warmup=1

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --smoke --mesh 1,1,2 --steps 3 --seq 32 --batch 2 \
        --comm-spec tp=taco:folded:chunks=4

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --smoke --mesh 1,2,2 --steps 3 --seq 32 --batch 4 \
        --comm-spec tp=taco,grad_rs=sdp4bit

``--sp k`` carves a sequence-parallel axis ``seq`` of k ranks out of the
data axis (the seq mesh ``pod, data/k, seq, model`` of ``launch/mesh.py``;
the world is still pod*data*model processes): each rank takes a 1/k
shard of its rows' sequence, and attention crosses the seq group through
the ``sp=`` codec, by Ulysses all-to-alls or, with ``--sp-mode ring``, by
ring permutes of the KV blocks.  ``--sp`` must divide the data axis and
``--seq``.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --smoke --mesh 1,4,1 --sp 2 --sp-mode ring --steps 3 \
        --seq 32 --batch 4 --comm-spec tp=taco,sp=taco:folded

``--ckpt DIR`` saves the global state (every rank's shards gathered; rank
0 writes) every max(steps / 4, 10) steps and at the last, in the JAX
package's layout (``ckpt/checkpoint.py``); with ``--resume`` (the
default) a run starts from the latest checkpoint in DIR, on any mesh
whose padded shapes match (``runtime/elastic.py`` ``replan``).
"""
from __future__ import annotations

import argparse
import statistics

import torch.distributed as dist

from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core.parallel import ParallelCtx
from repro_torch.core.registry import from_spec, to_spec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.core.parallel import SP_AXIS
from repro_torch.launch._args import (DEFAULT_SPEC, add_policy_alias,
                                      resolve_comm_spec)
from repro_torch.launch.mesh import AXES, SP_AXES, init_mesh, parse_mesh
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (CPU-sized); --no-smoke for full")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 64 smoke, 4096 full)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--comm-spec", default=None, dest="comm_spec",
                    help="compression plan spec or alias, e.g. "
                         "'tp=taco,warmup=10' or 'baseline' (default: "
                         f"{DEFAULT_SPEC})")
    add_policy_alias(ap)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1,1,1",
                    help="pod,data,model; more than one rank runs under "
                         "torchrun with pod*data*model processes")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel axis size; carves a 'seq' axis "
                         "out of the data axis (data must stay divisible). "
                         "Attention crosses it via the 'sp=' codec path "
                         "(--comm-spec \"sp=taco:folded\")")
    ap.add_argument("--sp-mode", default="ulysses", dest="sp_mode",
                    choices=["ulysses", "ring"],
                    help="sp attention flavor: Ulysses heads<->sequence "
                         "all-to-all, or blockwise ring over compressed "
                         "KV ppermute hops")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir: the state is saved every "
                         "max(steps/4, 10) steps and at the last (default: "
                         "no checkpoint)")
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="start from the latest checkpoint in --ckpt")
    return ap.parse_args(argv)


def build_trainer(args, group=None, mesh=None):
    """(trainer, cfg) for parsed launcher args; the optimizer schedule is
    the JAX launcher's (lr_min = lr/10, warmup max(steps/20, 5)).  The
    process groups are ``mesh``'s when given (a ``launch.mesh.Mesh``), or
    ``group`` as the TP group of a ``1,1,P`` mesh, else joined from the
    ``torchrun`` environment when the mesh has more than one rank (the
    seq mesh under ``--sp`` > 1), else none (this process alone).  The
    groups must match ``--mesh`` and ``--sp``; a ``mesh`` with a seq axis
    of one rank threads that group through.  An ``--sp`` that does not
    divide the data axis or ``--seq`` exits, as the JAX launcher does."""
    shape = parse_mesh(args.mesh)
    sp = args.sp
    if sp > 1 and shape[1] % sp:
        raise SystemExit(f"--sp {sp} must divide the data axis "
                         f"size {shape[1]}")
    seq = args.seq or (64 if args.smoke else 4096)
    if seq % sp:
        raise SystemExit(f"--seq {seq} must be divisible by --sp {sp}")
    plan = from_spec(resolve_comm_spec(args))
    if mesh is None and group is None and shape[0] * shape[1] * shape[2] > 1:
        mesh_shape, axes = ((shape[0], shape[1] // sp, sp, shape[2]),
                            SP_AXES) if sp > 1 else (shape, AXES)
        mesh = init_mesh(mesh_shape, args.device or "cuda", axes=axes)
    if mesh is not None:
        ctx = mesh.parallel_ctx(plan, args.sp_mode)
    else:
        ctx = ParallelCtx(plan=plan, group=group, sp_mode=args.sp_mode)
    if (ctx.fsdp_size * ctx.sp_size(), ctx.tp_size, ctx.sp_size()) != \
            (shape[0] * shape[1], shape[2], sp):
        raise ValueError(
            f"mesh {args.mesh} at --sp {sp} wants "
            f"{shape[0] * shape[1] // sp} fsdp x {sp} seq x {shape[2]} TP "
            f"ranks, the process groups have {ctx.fsdp_size} x "
            f"{ctx.sp_size()} x {ctx.tp_size}")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    model = Model(cfg, make_plan(cfg, ctx.tp_size, ctx.fsdp_size),
                  device=args.device, tp_rank=ctx.tp_rank,
                  fsdp_rank=ctx.fsdp_rank,
                  sp_axis=SP_AXIS if ctx.sp_active else None,
                  sp=ctx.sp_size(), sp_rank=ctx.sp_index())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=args.batch), cfg)
    oc = OptConfig(lr_max=args.lr, lr_min=args.lr / 10,
                   warmup_steps=max(args.steps // 20, 5),
                   total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps,
                       ckpt_every=max(args.steps // 4, 10),
                       ckpt_dir=args.ckpt, seed=args.seed)
    return Trainer(model, ctx, oc, tc, data), cfg


def main(argv=None):
    args = parse_args(argv)
    trainer, cfg = build_trainer(args)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        _, _, hist = trainer.run(resume=args.resume)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank != 0:
        return
    if not hist:
        print(f"{cfg.name}: the checkpoint in {args.ckpt} is at step "
              f"{args.steps} already; nothing to run")
        return
    for h in hist:
        print(f"step {h['step']} loss {h['loss']:.4f} "
              f"grad_norm {h['grad_norm']:.4f} lr {h['lr']:.3e} "
              f"{h['ms']:.1f} ms {h['tok_per_s']:.1f} tok/s plan {h['plan']}")
    warm = hist[1:] or hist
    print(f"{cfg.name}: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"({len(hist)} steps, comm_spec={to_spec(trainer.ctx.plan)}, "
          f"device={trainer.model.device}, mesh={args.mesh}"
          f"{f', sp={args.sp} {args.sp_mode}' if args.sp > 1 else ''}); "
          "after "
          f"the first step: "
          f"{statistics.mean(h['ms'] for h in warm):.1f} ms/step, "
          f"{statistics.mean(h['tok_per_s'] for h in warm):.1f} tok/s")


if __name__ == "__main__":
    main()
