"""Public model API: param specs -> init (or JAX weights) on a device,
the training loss and the batch shapes.

``Model`` binds (ArchConfig, RunPlan) to a device and to one rank of the
plan's TP group.  It runs on CUDA unless the caller passes
``device="cpu"``; without a card and without that request it raises —
nothing falls back to the CPU.

Parameters are this rank's shards: every global (padded) parameter is
made in full and cut along its spec's ``tp_dim`` into ``plan.tp`` equal
slices, of which rank r keeps slice r (the rule of the JAX package's
multi-device check, ``tests/multidev/check_tp_model.py``).  So tp = 1 and
tp = P start from the same weights wherever their padded global shapes
agree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunPlan
from repro_torch.models import transformer
from repro_torch.models.layers import (COMPUTE_DTYPE, ParamSpec,
                                       init_params, tree_map)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "(CLI --device cpu) to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: same 16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


class Model:
    """(ArchConfig, RunPlan) on a device; parameters are a nested dict in
    the JAX package's tree layout."""

    def __init__(self, cfg: ArchConfig, plan: RunPlan, *, device=None,
                 tp_rank: int = 0):
        transformer.check_family(cfg)
        if plan.fsdp != 1:
            raise NotImplementedError(
                f"fsdp={plan.fsdp}: sharded weights over a data axis are not "
                "ported; the port runs tensor parallelism only")
        if not 0 <= tp_rank < plan.tp:
            raise ValueError(f"tp_rank {tp_rank} outside the plan's tp "
                             f"{plan.tp}")
        self.cfg, self.plan, self.tp_rank = cfg, plan, tp_rank
        self.device = resolve_device(device)

    def specs(self):
        """Global (padded) parameter specs, the JAX package's."""
        return transformer.model_specs(self.cfg, self.plan)

    def shard(self, spec: ParamSpec, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a global parameter along ``spec.tp_dim``."""
        if spec.tp_dim is None or self.plan.tp == 1:
            return full
        width = spec.shape[spec.tp_dim] // self.plan.tp
        return full.narrow(spec.tp_dim, self.tp_rank * width,
                           width).contiguous()

    def init(self, seed: int = 0, dtype=COMPUTE_DTYPE):
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``, made on the model's device: every rank draws the same
        global parameters and keeps its shard."""
        return init_params(self.specs(), seed, self.device, dtype,
                           cut=self.shard)

    def from_jax_params(self, tree):
        """Carry JAX parameters across: ``tree`` is the JAX param pytree of
        GLOBAL (padded) arrays with numpy leaves (``jax.device_get``); bf16
        leaves keep their bits.  Shapes are checked against this model's
        specs, then each leaf is cut to this rank's shard."""
        def conv(spec: ParamSpec, a):
            t = _to_tensor(a, self.device)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"param shape {tuple(t.shape)} != spec "
                                 f"{spec.shape}")
            return self.shard(spec, t)
        return tree_map(conv, self.specs(), tree)

    # ---- training ---------------------------------------------------------
    def batch_shape(self, seq_len: int, global_batch: int) -> dict:
        """Train-batch ``(shape, dtype)`` by key, as the data pipeline
        emits them (token ids in torch's index dtype)."""
        b, s = global_batch, seq_len
        return {"tokens": ((b, s), torch.int64),
                "labels": ((b, s), torch.int64),
                "mask": ((b, s), torch.float32)}

    def loss_parts(self, params, batch, ctx):
        """(loss_sum, count, aux): f32 sums over this rank's batch."""
        return transformer.forward_train(params, batch, self.cfg, self.plan,
                                         ctx)
