"""Fault-tolerance walkthrough of the PyTorch port: train, kill mid-run
(injected), restart from the atomic checkpoint, and check that the final
params are bitwise equal to an uninterrupted run's — then probe elastic
mesh-reshape compatibility.  The twin of ``examples/elastic_restart.py``.

    PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu

(A restore at another mesh runs in ``tests/test_torch_restart.py``, on
four gloo processes.)
"""
import argparse
import logging
import os
import tempfile

import torch

from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core.parallel import ParallelCtx
from repro_torch.core.registry import from_spec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig, leaves
from repro_torch.runtime.elastic import replan
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    cfg = smoke_config(get_config("qwen2-0.5b"))
    plan = make_plan(cfg, 1, 1)
    model = Model(cfg, plan, device=args.device)
    ctx = ParallelCtx(plan=from_spec("baseline"))
    oc = OptConfig(lr_max=1e-3, warmup_steps=3, total_steps=16)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8), cfg)

    with tempfile.TemporaryDirectory() as tmp:
        def config(name):
            return TrainerConfig(total_steps=16, ckpt_every=8,
                                 ckpt_dir=os.path.join(tmp, name),
                                 log_every=100)

        print("1) uninterrupted reference run (16 steps)...")
        ref, _, _ = Trainer(model, ctx, oc, config("ref"), data).run(
            resume=False)

        print("2) run with an injected node failure at step 11 ->")
        print("   trainer restores the step-8 checkpoint and replays")
        tr = Trainer(model, ctx, oc, config("fail"), data,
                     injector=FailureInjector(fail_at_steps=[11]))
        failed, _, _ = tr.run(resume=False)

    same = all(torch.equal(a, b) for a, b in zip(leaves(ref),
                                                 leaves(failed)))
    print(f"   bitwise-identical final params after restart: {same}")
    if not same:
        raise SystemExit("the restarted run's params differ")

    print("3) elastic reshape compatibility (checkpoint is mesh-free):")
    for new_tp, new_fsdp in [(1, 4), (2, 2), (4, 16)]:
        rep = replan(cfg, plan, new_tp, new_fsdp)
        print(f"   tp={new_tp:2d} fsdp={new_fsdp:2d}: "
              f"{'OK - ' + rep.reason if rep.ok else 'REJECT - ' + rep.reason}")


if __name__ == "__main__":
    main()
