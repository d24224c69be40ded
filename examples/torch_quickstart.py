"""Quickstart of the PyTorch port: train a tiny TACO-compressed LM for 30
steps — the twin of ``examples/quickstart.py``.  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import logging
import tempfile

from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core.parallel import ParallelCtx
from repro_torch.core.registry import from_spec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, tp=1, fsdp=1), device=args.device)

    # full TACO plan: FP8 E4M3, ASH block 256, dual-scale metadata — one
    # declarative spec string instead of hand-wired codec objects
    ctx = ParallelCtx(plan=from_spec("tp=taco"))

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8), cfg)
    oc = OptConfig(lr_max=1e-3, warmup_steps=5, total_steps=args.steps)
    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainerConfig(total_steps=args.steps,
                           ckpt_every=max(args.steps // 2, 1), log_every=5,
                           ckpt_dir=ckpt)
        _, _, hist = Trainer(model, ctx, oc, tc, data).run(resume=False)
    print(f"first loss {hist[0]['loss']:.4f} -> last loss "
          f"{hist[-1]['loss']:.4f} (TACO-compressed TP communication "
          f"throughout, device {model.device})")
    return hist


if __name__ == "__main__":
    main()
