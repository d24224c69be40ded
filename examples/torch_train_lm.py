"""End-to-end training example of the PyTorch port: a ~100M-parameter GPT with
TACO on every TP hop and SDP4bit on every weight gradient — the twin of
``examples/train_lm.py``.  Runs on the card unless ``--device cpu``.

The default is gpt-100m at its full width (12 layers x 768, 12 heads,
vocab 32000); ``--scale tiny`` is its smoke reduction for CI.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --scale tiny \\
        --steps 40 --device cpu
"""
import argparse
import logging

from repro_torch.configs import make_plan, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.parallel import ParallelCtx
from repro_torch.core.registry import from_spec, to_spec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

GPT_100M = ArchConfig(
    name="gpt-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32000, head_dim=64,
    qkv_bias=True, mlp="gelu", norm="layernorm", pos="learned",
    source="examples/train_lm.py (~100M end-to-end driver)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", default="100m", choices=["100m", "tiny"])
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: no checkpoint)")
    ap.add_argument("--comm-spec", dest="comm_spec",
                    default="tp=taco,grad_rs=sdp4bit",
                    help="compression plan spec (e.g. 'baseline', "
                         "'tp=taco:folded,warmup=20'; docs/COMPRESSION.md)")
    ap.add_argument("--no-compress", action="store_true",
                    help="shorthand for --comm-spec baseline")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config(scale: str) -> ArchConfig:
    """gpt-100m at ``--scale 100m``, its smoke reduction at ``tiny``."""
    return GPT_100M if scale == "100m" else smoke_config(GPT_100M)


def build(args):
    """(trainer, cfg) of parsed args."""
    cfg = config(args.scale)
    seq = args.seq if args.scale == "100m" else 64
    model = Model(cfg, make_plan(cfg, tp=1, fsdp=1), device=args.device)
    print(f"params ~{cfg.param_count / 1e6:.1f}M  seq={seq} "
          f"batch={args.batch} steps={args.steps}")
    comm_plan = from_spec("baseline" if args.no_compress else args.comm_spec)
    print(f"comm spec: {to_spec(comm_plan)}")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=args.batch), cfg)
    oc = OptConfig(lr_max=3e-4, lr_min=3e-5, warmup_steps=20,
                   total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=100, log_every=10,
                       ckpt_dir=args.ckpt)
    return Trainer(model, ParallelCtx(plan=comm_plan), oc, tc, data), cfg


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    trainer, _ = build(args)
    _, _, hist = trainer.run(resume=args.ckpt is not None)
    where = f"checkpoints in {args.ckpt}" if args.ckpt else "no checkpoint"
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {len(hist)} steps on {trainer.model.device}; {where}")
    return hist


if __name__ == "__main__":
    main()
