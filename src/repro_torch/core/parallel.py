"""Parallelism context: the mesh's process groups + the declarative
per-path codec plan.

Models never move tensors between devices themselves; they go through a
``ParallelCtx`` so that every communication site is a named, compressible
path of a :class:`CommPlan` (paper Fig. 7 integration points):

  tp_fwd / tp_bwd : TP intermediate tensors          -> TACO (the paper)
  grad_rs         : DP/fsdp gradient reduce-scatter
  weight_ag       : fsdp weight all-gather
  pp              : pipeline stage boundaries
  sp              : sequence-parallel attention hops

Plans are built from spec strings by ``repro_torch.core.registry``.  The
port runs both TP modes over a ``torch.distributed`` process group (NCCL
on the cards, gloo on the CPU; :func:`init_tp_group` builds it), or on
this process alone: Megatron-SP (``sp_gather`` / ``sp_scatter``, the
training path) and AllReduce (``tp_g`` / ``tp_f``, the decode path).
Weights are fsdp-sharded over the groups of the fsdp axes — ``(pod,
data)`` on the pod mesh, ``(data,)`` on the pipe mesh (``launch/mesh.py``
builds them): ``weight_gather`` all-gathers a weight
at each use through the ``weight_ag`` codec, and its backward — the
reduce-scatter of the weight gradient over the data axes — goes through
the ``grad_rs`` codec (ZeRO falls out of the chain rule).  On the pipe
mesh, ``pipe_group`` carries the stage boundaries' sends through the
``pp`` codec (``train/pipeline_parallel.py``).  On the seq mesh,
``sp_group`` carries sequence-parallel attention through the ``sp`` codec
(``models/attention.py``: Ulysses all-to-alls or ring permutes).
``CommPlan.at_step`` resolves the warmup schedule per optimizer step,
outside the step function, as the JAX trainer does.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.core import collectives as cc
from repro_torch.core.codecs import IdentityCodec

Identity = IdentityCodec()

PATHS = ("tp_fwd", "tp_bwd", "grad_rs", "weight_ag", "pp", "sp")
#: the mesh axes that shard weights and the batch on the pod mesh,
#: outermost first, the tensor-parallel axis and the pipeline axis
#: (``launch/mesh.py``)
FSDP_AXES = ("pod", "data")
TP_AXIS = "model"
PIPE_AXIS = "pipe"
#: the Ulysses / ring sequence-parallel axis (``launch/mesh.py``)
SP_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Frozen per-path compression plan (same fields as the JAX plan)."""

    tp_fwd: object = Identity
    tp_bwd: object = Identity
    grad_rs: object = Identity
    weight_ag: object = Identity
    pp: object = Identity
    sp: object = Identity
    skip_first: int = 0      # first N layers: TP identity
    skip_last: int = 0       # last N layers: TP identity
    warmup_steps: int = 0    # identity plan for the first K steps

    @property
    def tp_identity(self) -> bool:
        return self.tp_fwd == Identity and self.tp_bwd == Identity

    def steady(self) -> "CommPlan":
        """The plan with the step schedule stripped (what runs after
        warmup)."""
        if self.warmup_steps == 0:
            return self
        return dataclasses.replace(self, warmup_steps=0)

    def at_step(self, step: int) -> "CommPlan":
        """The identity plan before ``warmup_steps``, the steady plan from
        then on."""
        if step < self.warmup_steps:
            return CommPlan()
        return self.steady()

    def layer_plans(self, total: int) -> tuple["CommPlan", ...]:
        """The per-layer plan of each of ``total`` layers, expanded from
        :meth:`layer_spans` (for tests and telemetry; the model runs the
        spans)."""
        return tuple(plan for n, plan in self.layer_spans(0, total, total)
                     for _ in range(n))

    def layer_spans(self, start: int, count: int,
                    total: int) -> tuple[tuple[int, "CommPlan"], ...]:
        """Per-layer overrides resolved to contiguous ``(span_count, plan)``
        spans for ``count`` layers from absolute index ``start`` of a
        ``total``-layer stack: layers in [0, skip_first) and
        [total - skip_last, total) get the TP-identity variant."""
        if count <= 0:
            return ()
        lo = min(self.skip_first, total)
        hi = max(total - self.skip_last, lo)
        if (self.skip_first == 0 and self.skip_last == 0) or \
                self.tp_identity:
            return ((count, self),)
        skipped = dataclasses.replace(self, tp_fwd=Identity, tp_bwd=Identity)
        spans: list[tuple[int, CommPlan]] = []
        for a, b, plan in ((start, min(start + count, lo), skipped),
                           (max(start, lo), min(start + count, hi), self),
                           (max(start, hi), start + count, skipped)):
            n = b - a
            if n > 0:
                if spans and spans[-1][1] == plan:
                    spans[-1] = (spans[-1][0] + n, plan)
                else:
                    spans.append((n, plan))
        return tuple(spans)

    def wire_bytes_per_element(self, n: int | None = None) -> dict:
        """Per-path wire bytes per element (2.0 = bf16).  With ``n`` (the
        elements of one hop's slot) the exact packed bytes of the path's
        hop over ``n``, the transport's padding included: the AG/RS hops
        pad to ``chunks * granule``; the ``pp`` and ``sp`` hops (a
        permute, an all-to-all) never ring, so they pad to the granule
        alone.  Without ``n`` the asymptotic ratio (the trainer's
        per-step telemetry, where no single slot size exists).  The
        identity codec reports its raw bytes either way."""
        out = {}
        for path in PATHS:
            codec = getattr(self, path)
            if n is not None:
                slot = cc.wire_slot_bytes(
                    codec, n, chunks=1 if path in ("pp", "sp") else None)
                if slot is not None:
                    out[path] = slot / n
                    continue
            out[path] = float(codec.bytes_per_element())
        return out

    def wire_chunks(self) -> dict:
        """Per-path ring chunk counts (1 = monolithic transport)."""
        return {path: int(getattr(getattr(self, path), "chunks", 1))
                for path in PATHS}

    def wire_variable(self) -> dict:
        """Per-path flags: does the codec publish a variable
        (bounded-but-ragged) wire layout?  Then the bytes per element are
        the slot bound, and the achieved bytes depend on the data."""
        out = {}
        for path in PATHS:
            codec = getattr(self, path)
            wl = getattr(codec, "wire_layout", None)
            layout = wl(codec.granule) if wl is not None else None
            out[path] = bool(layout is not None
                             and getattr(layout, "variable", False))
        return out

    def slot_modes(self) -> dict:
        """Per-path slot policy: ``"auto"`` where the codec opted into
        renegotiation (``slot=auto``), ``"static"`` elsewhere."""
        return {path: getattr(getattr(self, path), "slot", "static")
                for path in PATHS}

    def has_auto_slots(self) -> bool:
        """True when any path runs under ``slot=auto`` (a
        ``collectives.SlotController`` should drive this plan)."""
        return any(m == "auto" for m in self.slot_modes().values())

    def escalation_modes(self) -> dict:
        """Per-path error-escalation policy: ``(fallback_name,
        threshold)`` where the codec carries ``escalate=``, else None."""
        return {path: getattr(getattr(self, path), "escalate", None)
                for path in PATHS}

    def has_escalation(self) -> bool:
        """True when any path carries an ``escalate=`` policy (a
        ``policy.ErrorEscalationController`` should drive this plan)."""
        return any(e is not None
                   for e in self.escalation_modes().values())


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The mesh's groups + codec plan, passed through the model stack.

    ``group`` is the tensor-parallel ``torch.distributed`` process group of
    this process, or ``None`` for this process alone; ``tp_size`` /
    ``tp_rank`` are derived from it (without a group they may be set by
    hand, for code that only slices shards).  ``fsdp_groups`` are this
    process's groups along the fsdp axes ``("pod", "data")``, outermost
    first (``None``: a group of one, this process alone).  ``tp_mode`` is
    the training forward's TP mode: ``"sp"`` (Megatron-SP: the residual
    stream is sequence-sharded, every block enters through an all-gather
    and exits through a reduce-scatter) or ``"allreduce"`` (f/g).  The
    decode path always takes the f/g pair.  ``fsdp_axes`` names the fsdp
    axes, one per group of ``fsdp_groups`` (``None``: one group of one
    rank per axis); ``pipe_group`` is this process's group along the
    pipeline axis (``None``: one stage).

    ``sp_group`` is this process's group along the sequence-parallel axis
    ``"seq"`` (``None``: sequence parallelism off), over which the
    sequence dim of the batch is sharded — distinct from ``tp_mode``
    ``"sp"``, Megatron-SP's residual sharding over the TP group.
    Attention crosses it through the ``sp`` codec: the Ulysses
    heads<->sequence all-to-all (``sp_mode="ulysses"``) or the ring's
    KV-block permutes (``sp_mode="ring"``)."""

    tp_size: int = 1
    tp_rank: int = 0
    plan: CommPlan = CommPlan()
    tp_mode: str = "sp"
    group: object = None
    fsdp_groups: tuple | None = None
    fsdp_axes: tuple = FSDP_AXES
    pipe_group: object = None
    sp_group: object = None
    sp_mode: str = "ulysses"

    def __post_init__(self):
        if self.group is not None:
            object.__setattr__(self, "tp_size", cc.group_size(self.group))
            object.__setattr__(self, "tp_rank", cc.group_rank(self.group))
        if self.fsdp_groups is None:
            object.__setattr__(self, "fsdp_groups",
                               (None,) * len(self.fsdp_axes))
        if len(self.fsdp_groups) != len(self.fsdp_axes):
            raise ValueError(f"fsdp_groups: one group per axis of "
                             f"{self.fsdp_axes}, got {self.fsdp_groups!r}")

    @property
    def fsdp_size(self) -> int:
        """Ranks an fsdp-sharded weight (and the batch) is split over."""
        n = 1
        for g in self.fsdp_groups:
            n *= cc.group_size(g)
        return n

    @property
    def fsdp_rank(self) -> int:
        """This rank's fsdp index, pod-major: its weight shard and batch
        rows."""
        r = 0
        for g in self.fsdp_groups:
            r = r * cc.group_size(g) + cc.group_rank(g)
        return r

    def axis_group(self, axis: str):
        """What the collectives move over along a mesh axis name."""
        if axis == TP_AXIS:
            return self.comm
        if axis == PIPE_AXIS:
            return self.pipe_group
        if axis == SP_AXIS:
            return self.sp_group
        return self.fsdp_groups[self.fsdp_axes.index(axis)]

    @property
    def comm(self):
        """What the collectives move over: the group, or the bare size
        (1 moves nothing; a larger bare size raises at the first hop)."""
        return self.group if self.group is not None else self.tp_size

    def layer_views(self, start: int, count: int,
                    total: int) -> tuple[tuple[int, "ParallelCtx"], ...]:
        """Static per-layer ``ParallelCtx`` spans (see
        :meth:`CommPlan.layer_spans`)."""
        return tuple(
            (n, self if plan is self.plan
             else dataclasses.replace(self, plan=plan))
            for n, plan in self.plan.layer_spans(start, count, total))

    def sp_gather(self, x, dim: int):
        """Megatron-SP entry: compressed all-gather along ``dim`` (backward:
        the compressed reduce-scatter with the tp_bwd codec)."""
        return cc.all_gather_c(x, self.comm, dim, self.plan.tp_fwd,
                               self.plan.tp_bwd)

    def sp_scatter(self, x, dim: int):
        """Megatron-SP exit: compressed reduce-scatter along ``dim``
        (backward: the compressed all-gather with the tp_bwd codec)."""
        return cc.psum_scatter_c(x, self.comm, dim, self.plan.tp_fwd,
                                 self.plan.tp_bwd)

    def tp_g(self, x):
        """Megatron "g": compressed two-shot AllReduce over the TP group."""
        return cc.allreduce_g(x, self.comm, self.plan.tp_fwd,
                              self.plan.tp_bwd)

    def tp_f(self, x):
        """Megatron "f": identity forward; backward the compressed
        AllReduce with the tp_bwd codec."""
        return cc.copy_f(x, self.comm, self.plan.tp_fwd, self.plan.tp_bwd)

    def weight_gather(self, w, dim: int = 0):
        """fsdp weight gather along ``dim`` over the fsdp groups
        (innermost first: data, then pod) through the ``weight_ag`` codec;
        its backward is the weight gradient's reduce-scatter through the
        ``grad_rs`` codec, at every stage, a stage of one rank included.  With identity
        codecs and no group that moves, the gather is ``w`` itself."""
        if self.plan.weight_ag == Identity and \
                self.plan.grad_rs == Identity and \
                not any(cc.moves(g) for g in self.fsdp_groups):
            return w
        return cc.all_gather_c(w, self.fsdp_groups, dim,
                               self.plan.weight_ag, self.plan.grad_rs)

    def ep_all_to_all(self, x, split_dim: int, concat_dim: int):
        """The MoE expert-parallel dispatch (the paper's compressed
        all-to-all): one all-to-all over the TP group through the
        ``tp_fwd`` codec, its backward the inverse hop through
        ``tp_bwd``."""
        return cc.all_to_all_c(x, self.comm, split_dim, concat_dim,
                               self.plan.tp_fwd, self.plan.tp_bwd)

    # ---- sequence parallelism over the seq group --------------------------
    @property
    def sp_active(self) -> bool:
        """True when a seq group is threaded through (a group of one rank
        included: the flavours then run the monolithic core)."""
        return self.sp_group is not None

    def sp_size(self) -> int:
        """Ranks of the seq group (1 when sequence parallelism is off)."""
        return cc.group_size(self.sp_group) if self.sp_active else 1

    def sp_index(self) -> int:
        """This rank's place in the seq group (0 when off)."""
        return cc.group_rank(self.sp_group) if self.sp_active else 0

    def sp_all_to_all(self, x, split_dim: int, concat_dim: int):
        """The Ulysses redistribute: one compressed all-to-all over the
        seq group through the plan's ``sp`` codec in both directions (the
        backward swaps the dims, which is the inverse hop)."""
        return cc.all_to_all_c(x, self.sp_group, split_dim, concat_dim,
                               self.plan.sp, self.plan.sp)

    def sp_permute(self, x, perm):
        """One compressed point-to-point hop over the seq group (the ring's
        KV-block transfer) through the plan's ``sp`` codec."""
        return cc.ppermute_c(x, self.sp_group, perm, self.plan.sp,
                             self.plan.sp)


def init_tp_group(device, *, init_method: str = "env://",
                  world_size: int | None = None, rank: int | None = None,
                  timeout_s: float = 600.0):
    """Join (or start) the default process group and return it as the TP
    group.  The device's type picks the backend — NCCL for a CUDA device,
    gloo for the CPU — so the choice follows the data, not a fallback.
    ``init_method`` ``"env://"`` reads ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT`` as ``torchrun`` sets them; pass
    ``world_size`` and ``rank`` with any other (``tcp://127.0.0.1:<port>``,
    ``file://<path>``).  On CUDA each rank takes the card of its
    ``LOCAL_RANK`` (default: its rank modulo the card count).  Collectives
    that wait longer than ``timeout_s`` fail instead of hanging."""
    dev = torch.device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {dev}")
    if not dist.is_initialized():
        if init_method == "env://" and "RANK" not in os.environ:
            raise ValueError(
                "a TP group over env:// needs RANK / WORLD_SIZE / "
                "MASTER_ADDR / MASTER_PORT: start the launcher under "
                "torchrun --nproc-per-node P")
        kw = {}
        if world_size is not None:
            kw = {"world_size": int(world_size), "rank": int(rank or 0)}
        if backend == "nccl":
            r = int(os.environ.get("RANK", kw.get("rank", 0)))
            torch.cuda.set_device(int(os.environ.get(
                "LOCAL_RANK", r % torch.cuda.device_count())))
        dist.init_process_group(
            backend, init_method=init_method,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"but a {dev.type} device needs {backend}")
    return dist.group.WORLD


def iter_layer_spans(ctx: ParallelCtx, start: int, count: int, total: int,
                     *stacks):
    """Yield ``(span_count, span_ctx, *sliced_stacks)`` for each contiguous
    span of ``ctx.layer_views``; each stack is a nested dict of
    layer-stacked tensors (layer-major dim 0) sliced to the span's layers
    (views, no copies)."""
    def cut(tree, a, b):
        if isinstance(tree, dict):
            return {k: cut(v, a, b) for k, v in tree.items()}
        return tree[a:b]

    off = 0
    for span_n, span_ctx in ctx.layer_views(start, count, total):
        yield (span_n, span_ctx) + tuple(cut(s, off, off + span_n)
                                         for s in stacks)
        off += span_n
