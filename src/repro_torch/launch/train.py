"""Training launcher: build a model (random weights from ``--seed``) and run
``--steps`` Megatron-SP training steps on synthetic data, every TP hop
through the compressed collectives selected by ``--comm-spec``.  Runs on
the card unless ``--device cpu``.  Prints one line per step and a summary
(rank 0 only).

``--mesh 1,1,P`` runs tensor-parallel over P processes, one per rank,
started by ``torchrun`` (rank and world size from its environment): NCCL
with one card per rank, or gloo with ``--device cpu``.  Every rank draws
the same weights and the same batches and keeps its shards.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --no-smoke --steps 8 --seq 2048 --batch 4 --comm-spec taco

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --smoke --steps 3 --seq 32 --batch 2 --comm-spec tp=taco,warmup=1

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --smoke --mesh 1,1,2 --steps 3 --seq 32 --batch 2 \
        --comm-spec tp=taco:folded:chunks=4
"""
from __future__ import annotations

import argparse
import statistics

import torch.distributed as dist

from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core.parallel import ParallelCtx, init_tp_group, mesh_tp
from repro_torch.core.registry import from_spec, to_spec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
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
    ap.add_argument("--comm-spec", default="taco", dest="comm_spec",
                    help="compression plan spec or alias, e.g. "
                         "'tp=taco,warmup=10' or 'baseline'")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1,1,1",
                    help="pod,data,model; 1,1,P runs TP over P processes "
                         "(torchrun)")
    return ap.parse_args(argv)


def build_trainer(args, group=None):
    """(trainer, cfg) for parsed launcher args; the optimizer schedule is
    the JAX launcher's (lr_min = lr/10, warmup max(steps/20, 5)).  The TP
    group is ``group`` when given (its size must be the mesh's model
    axis), else joined from the ``torchrun`` environment when the mesh's
    model axis is > 1, else none."""
    tp = mesh_tp(args.mesh)
    if group is None and tp > 1:
        group = init_tp_group(args.device or "cuda")
    ctx = ParallelCtx(plan=from_spec(args.comm_spec), group=group)
    if ctx.tp_size != tp:
        raise ValueError(f"mesh {args.mesh} wants a TP group of {tp}, the "
                         f"process group has {ctx.tp_size} ranks")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    model = Model(cfg, make_plan(cfg, tp, 1), device=args.device,
                  tp_rank=ctx.tp_rank)
    seq = args.seq or (64 if args.smoke else 4096)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=args.batch), cfg)
    oc = OptConfig(lr_max=args.lr, lr_min=args.lr / 10,
                   warmup_steps=max(args.steps // 20, 5),
                   total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, seed=args.seed)
    return Trainer(model, ctx, oc, tc, data), cfg


def main(argv=None):
    args = parse_args(argv)
    trainer, cfg = build_trainer(args)
    try:
        _, _, hist = trainer.run()
    finally:
        if trainer.ctx.group is not None:
            dist.destroy_process_group()
    if trainer.ctx.tp_rank != 0:
        return
    for h in hist:
        print(f"step {h['step']} loss {h['loss']:.4f} "
              f"grad_norm {h['grad_norm']:.4f} lr {h['lr']:.3e} "
              f"{h['ms']:.1f} ms {h['tok_per_s']:.1f} tok/s plan {h['plan']}")
    warm = hist[1:] or hist
    print(f"{cfg.name}: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"({len(hist)} steps, comm_spec={to_spec(trainer.ctx.plan)}, "
          f"device={trainer.model.device}, tp={trainer.ctx.tp_size}); after "
          f"the first step: "
          f"{statistics.mean(h['ms'] for h in warm):.1f} ms/step, "
          f"{statistics.mean(h['tok_per_s'] for h in warm):.1f} tok/s")


if __name__ == "__main__":
    main()
