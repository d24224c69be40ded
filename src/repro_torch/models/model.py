"""Public model API: param specs -> init (or JAX weights) on a device,
the training loss and the batch shapes.

``Model`` binds (ArchConfig, RunPlan) to a device and to one rank of the
plan's mesh: its TP rank and its fsdp rank.  It runs on CUDA unless the
caller passes ``device="cpu"``; without a card and without that request
it raises — nothing falls back to the CPU.

Parameters are this rank's shards: every global (padded) parameter is
made in full and cut along its spec's ``tp_dim`` into ``plan.tp`` equal
slices, of which TP rank r keeps slice r (the rule of the JAX package's
multi-device check, ``tests/multidev/check_tp_model.py``), then along its
``fsdp_dim`` into ``plan.fsdp`` slices, of which fsdp rank f (pod-major:
``pod * data + data_index``) keeps slice f, as the JAX package's
``partition_spec`` shards over ``("pod", "data")`` (or over the model's
``fsdp_axes``: ``("data",)`` on the pipe mesh).  On a pipe mesh of
``pipe`` stages, every leaf of a layer stack is cut last along its
leading (layer) dim, and stage s keeps layers ``[s * L/pipe, (s + 1) *
L/pipe)`` — the JAX package's ``pipe_partition_specs``; the embedding,
the positions, the final norm and the head stay whole on every stage.  So
every mesh starts from the same weights wherever the padded global shapes
agree.  The batch is split the same way: fsdp rank f takes rows ``[f *
B/F, (f + 1) * B/F)`` of the global batch (``batch_slice``).

On the seq mesh (``sp_axis="seq"``, ``sp`` ranks) every parameter is
replicated over the seq axis, and seq rank i takes positions ``[i * S/sp,
(i + 1) * S/sp)`` of its rows: the JAX package's ``batch_pspecs`` shard
the sequence dim over the sp axis.  Its grads are summed over the seq
group once the backward is done (``replicated_grad_axes``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunPlan
from repro_torch.core import collectives as cc
from repro_torch.core.collectives import Identity, all_gather_c
from repro_torch.core.parallel import FSDP_AXES, SP_AXIS, TP_AXIS
from repro_torch.data import pipeline as data_pipeline
from repro_torch.models import transformer
from repro_torch.models.layers import (COMPUTE_DTYPE, ParamSpec,
                                       init_params, tree_map)

#: the families whose layers carry a state along the sequence
RECURRENT = ("rwkv", "hybrid")


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


def _gather_bytes(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``group`` (a group or a tuple of groups),
    concatenated along ``dim`` in rank order, bit for bit: each element
    crosses as its bytes (uint8, a trailing dim of the item size), so any
    dtype crosses any backend."""
    raw = x.contiguous().view(torch.uint8).reshape(*x.shape, x.element_size())
    out = all_gather_c(raw, group, dim, Identity, Identity)
    return out.reshape(*out.shape[:-2], -1).view(x.dtype)


def _stacked_ids(specs) -> set:
    """The ids of the specs of ``specs`` that are leaves of a layer stack
    (``specs["segments"]``)."""
    ids: set = set()
    tree_map(lambda s: ids.add(id(s)), specs["segments"])
    return ids


class Model:
    """(ArchConfig, RunPlan) on a device; parameters are a nested dict in
    the JAX package's tree layout."""

    tp_axis = TP_AXIS

    def __init__(self, cfg: ArchConfig, plan: RunPlan, *, device=None,
                 tp_rank: int = 0, fsdp_rank: int = 0,
                 fsdp_axes: tuple = FSDP_AXES, pipe: int = 1,
                 pipe_rank: int = 0, sp_axis: str | None = None,
                 sp: int = 1, sp_rank: int = 0):
        if sp_axis is not None and (cfg.family == "encdec"
                                    or cfg.frontend == "patches"):
            raise NotImplementedError(
                "sequence parallelism supports the decoder-only token "
                "frontend (encdec/patches sequence composition is not "
                "sp-sharded)")
        if sp_axis is not None and cfg.family in RECURRENT:
            raise NotImplementedError(
                f"{cfg.name}: sequence parallelism is refused for the "
                f"{cfg.family!r} family.  Its recurrence and token shift "
                "carry state along the sequence, and the JAX package "
                "starts each seq shard from zeros, so its result is not the "
                "unsharded model's: --smoke --steps 1 --seq 32 --batch 2 "
                "--mesh 1,2,1 --comm-spec baseline on four host devices "
                "gives a first-step loss / grad norm of 6.2953 / 1.908 at "
                "sp = 1 and 6.2966 / 1.887 at sp = 2 for rwkv6-1.6b-smoke, "
                "6.3247 / 2.707 and 6.3251 / 2.708 for hymba-1.5b-smoke "
                "(qwen2-0.5b-smoke: 6.2506 / 3.391 at both)")
        transformer.check_family(cfg)
        if sp_axis not in (None, SP_AXIS) or (sp_axis is None and sp != 1) \
                or not 0 <= sp_rank < sp:
            raise ValueError(f"sp rank {sp_rank} of {sp} on axis "
                             f"{sp_axis!r}: want the {SP_AXIS!r} axis")
        if cfg.n_layers % pipe or not 0 <= pipe_rank < pipe:
            raise ValueError(f"pipe rank {pipe_rank} of {pipe} stages: "
                             f"{cfg.n_layers} layers must split evenly")
        if not 0 <= tp_rank < plan.tp:
            raise ValueError(f"tp_rank {tp_rank} outside the plan's tp "
                             f"{plan.tp}")
        if not 0 <= fsdp_rank < plan.fsdp:
            raise ValueError(f"fsdp_rank {fsdp_rank} outside the plan's "
                             f"fsdp {plan.fsdp}")
        self.cfg, self.plan = cfg, plan
        self.tp_rank, self.fsdp_rank = tp_rank, fsdp_rank
        self.fsdp_axes = tuple(fsdp_axes)
        self.pipe, self.pipe_rank = pipe, pipe_rank
        self.sp_axis, self.sp, self.sp_rank = sp_axis, sp, sp_rank
        self.device = resolve_device(device)

    def specs(self):
        """Global (padded) parameter specs, the JAX package's."""
        return transformer.model_specs(self.cfg, self.plan)

    def abstract_params(self, dtype=COMPUTE_DTYPE):
        """The global (padded) parameters as ``meta`` tensors of
        ``dtype``: shapes and types, nothing allocated (the JAX package's
        ``abstract_params``; ``launch/dryrun.py`` cuts them as
        :meth:`shard` does)."""
        return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                              device="meta"), self.specs())

    def shard(self, spec: ParamSpec, full: torch.Tensor,
              stacked: bool = False) -> torch.Tensor:
        """This rank's slice of a global parameter: along ``spec.tp_dim``
        by the TP rank, then along ``spec.fsdp_dim`` by the fsdp rank, then
        (a leaf of a layer stack) along dim 0 by the pipe rank."""
        out = full
        for dim, n, r in ((spec.tp_dim, self.plan.tp, self.tp_rank),
                          (spec.fsdp_dim, self.plan.fsdp, self.fsdp_rank),
                          (0 if stacked else None, self.pipe,
                           self.pipe_rank)):
            if dim is None or n == 1:
                continue
            if out.shape[dim] % n:
                raise ValueError(f"param dim {dim} of {spec.shape} does not "
                                 f"split into {n} shards")
            width = out.shape[dim] // n
            out = out.narrow(dim, r * width, width)
        return out if out is full else out.contiguous()

    def replicated_grad_axes(self, spec: ParamSpec) -> tuple:
        """Mesh axes over which this param's grads are summed after the
        backward (params replicated over an axis but used divergently:
        norm scales and replicated kv weights over the model axis;
        params with no ``fsdp_dim`` over the fsdp axes as well; every
        param over the seq axis, whose ranks saw other positions)."""
        axes = []
        if spec.tp_dim is None:
            axes.append(self.tp_axis)
        if spec.fsdp_dim is None:
            axes.extend(self.fsdp_axes)
        if self.sp_axis is not None:
            axes.append(self.sp_axis)
        return tuple(axes)

    def init(self, seed: int = 0, dtype=COMPUTE_DTYPE):
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``, made on the model's device: every rank draws the same
        global parameters and keeps its shard."""
        specs = self.specs()
        stacked = _stacked_ids(specs)
        return init_params(specs, seed, self.device, dtype,
                           cut=lambda s, a: self.shard(s, a,
                                                       id(s) in stacked))

    def cut_params(self, tree):
        """This rank's shards of a tree of GLOBAL (padded) tensors in the
        parameter layout (the parameters, or AdamW's master weights or
        moments), each on the model's device: shapes are checked against
        this model's specs, then each leaf is cut as :meth:`shard` cuts it
        (TP, fsdp, then the stage's layers)."""
        specs = self.specs()
        stacked = _stacked_ids(specs)

        def cut(spec: ParamSpec, t):
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"param shape {tuple(t.shape)} != spec "
                                 f"{spec.shape}")
            return self.shard(spec, t, id(spec) in stacked).to(self.device)
        return tree_map(cut, specs, tree)

    def from_jax_params(self, tree):
        """Carry JAX parameters across: ``tree`` is the JAX param pytree of
        GLOBAL (padded) arrays with numpy leaves (``jax.device_get``); bf16
        leaves keep their bits (:meth:`cut_params`)."""
        return self.cut_params(tree_map(lambda a: _to_tensor(a, "cpu"),
                                        tree))

    def unshard(self, spec: ParamSpec, part: torch.Tensor, ctx,
                stacked: bool = False) -> torch.Tensor:
        """The inverse of :meth:`shard`: the global parameter from this
        rank's ``part``, gathered over the pipe group (a leaf of a layer
        stack, along dim 0), the fsdp groups (along ``spec.fsdp_dim``,
        innermost first) and the TP group (along ``spec.tp_dim``) of
        ``ctx``.  Every rank of those groups calls it, in the same order,
        and gets the whole parameter; a group of one rank copies through
        ``torch.distributed`` too.  The bytes move as they are, whatever
        the dtype."""
        out = part
        for dim, n, group in ((0 if stacked else None, self.pipe,
                               ctx.pipe_group),
                              (spec.fsdp_dim, self.plan.fsdp,
                               tuple(ctx.fsdp_groups)),
                              (spec.tp_dim, self.plan.tp, ctx.comm)):
            if dim is None:
                continue
            size = math.prod(cc.group_size(g) for g in (
                group if isinstance(group, tuple) else (group,)))
            if size != n:
                raise ValueError(f"param dim {dim} of {spec.shape} is cut "
                                 f"into {n} shards, its group has {size} "
                                 "ranks")
            out = _gather_bytes(out, group, dim)
        return out

    def gather_params(self, tree, ctx, device="cpu"):
        """:meth:`unshard` of every leaf of a tree in the parameter layout
        (the parameters, or AdamW's master weights or moments), each global
        leaf moved to ``device`` before the next is gathered."""
        specs = self.specs()
        stacked = _stacked_ids(specs)
        return tree_map(lambda s, t: self.unshard(
            s, t.detach(), ctx, id(s) in stacked).to(device), specs, tree)

    # ---- training ---------------------------------------------------------
    def batch_slice(self, batch: dict) -> dict:
        """This rank's rows of a global batch: the batch is sharded over
        the fsdp axes on dim 0, pod-major (the JAX package's
        ``batch_pspecs``); every TP rank of a data rank takes the same
        rows (frame and patch stubs too).  On the seq mesh, this seq
        rank's shard of the sequence dim (dim 1) of those rows."""
        rows = data_pipeline.dp_rows(batch, self.fsdp_rank, self.plan.fsdp)
        if self.sp_axis is None:
            return rows
        out = {}
        for k, v in rows.items():
            if v.shape[1] % self.sp:
                raise ValueError(f"batch {k}: sequence {v.shape[1]} does "
                                 f"not split over sp {self.sp}")
            w = v.shape[1] // self.sp
            lo = self.sp_rank * w
            out[k] = v[:, lo:lo + w].contiguous()
        return out

    def batch_shape(self, seq_len: int, global_batch: int) -> dict:
        """Train-batch ``(shape, dtype)`` by key, as the data pipeline
        emits them (token ids in torch's index dtype; the frontend stubs
        in bf16, split from ``seq_len`` by
        :func:`~repro_torch.data.pipeline.split_positions`)."""
        cfg = self.cfg
        b = global_batch
        key, n_stub, s_tok = data_pipeline.split_positions(cfg, seq_len)
        shapes = {}
        if key is not None:
            shapes[key] = ((b, n_stub, cfg.d_model), torch.bfloat16)
        shapes.update({"tokens": ((b, s_tok), torch.int64),
                       "labels": ((b, s_tok), torch.int64),
                       "mask": ((b, s_tok), torch.float32)})
        return shapes

    def loss_parts(self, params, batch, ctx):
        """(loss_sum, count, aux): f32 sums over this rank's batch."""
        return transformer.forward_train(params, batch, self.cfg, self.plan,
                                         ctx)
