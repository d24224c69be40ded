"""The process meshes: rank layout and process groups.

Three meshes, as the JAX package builds them:

  pod mesh  ``("pod", "data", "model")``: data parallelism and FSDP over
            pod x data, tensor parallelism over model (the train
            launcher's ``--mesh``);
  pipe mesh ``("pipe", "data", "model")``: pipeline stages over pipe,
            FSDP over data, tensor parallelism over model
            (``train/pipeline_parallel.py``, as the JAX package's
            ``tests/multidev/check_pipeline.py`` lays it out);
  seq mesh  ``("pod", "data", "seq", "model")``: the pod mesh with a
            sequence-parallel axis carved out of data, between data and
            model (the train launcher's ``--sp``; the JAX package's
            ``make_production_mesh(sp=...)``).  Parameters are replicated
            over seq and the batch's sequence dim is sharded over it.

Rank ``r`` of a mesh sits at the row-major coordinates of ``r``, the
model axis fastest — the device order that ``jax.make_mesh(shape,
axes)`` gives the JAX package.  So the ranks of one TP group are
neighbours, and the fsdp index of a rank (its shard of an fsdp-sharded
weight and its rows of the batch) is ``pod * data + data_index`` on the
pod and seq meshes, pod-major as the JAX package's ``PartitionSpec(("pod",
"data"))`` shards, and ``data_index`` on the pipe mesh.

:func:`init_mesh` builds one family of process groups per axis: each
group holds the ranks that differ only in that axis' coordinate.  Every
rank creates every group, in the same order (model, data, then pod or
pipe; within a family, by the other coordinates in row-major order):
``new_group`` is a collective call of the whole world, and ranks that
create groups in another order hang.  (On the seq mesh: model, seq,
data, pod.)
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch.distributed as dist

from repro_torch.core.parallel import (FSDP_AXES, PIPE_AXIS, SP_AXIS,
                                       TP_AXIS, ParallelCtx, init_tp_group)

AXES = FSDP_AXES + (TP_AXIS,)                  # the pod mesh
PIPE_AXES = (PIPE_AXIS, "data", TP_AXIS)       # the pipe mesh
SP_AXES = FSDP_AXES + (SP_AXIS, TP_AXIS)       # the seq mesh


def parse_mesh(text: str) -> tuple[int, int, int]:
    """``"pod,data,model"`` (or ``"pipe,data,model"``) -> the three axis
    sizes."""
    shape = tuple(int(v) for v in text.split(","))
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: want three axis sizes >= 1")
    return shape


def mesh_coords(rank: int, shape) -> tuple:
    """Row-major coordinates of ``rank`` (the last axis, model, fastest)."""
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} outside a {tuple(shape)} mesh")
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def mesh_rank(coords, shape) -> int:
    """Inverse of :func:`mesh_coords`."""
    r = 0
    for c, n in zip(coords, shape, strict=True):
        r = r * n + c
    return r


def axis_ranks(shape, axis: str, axes: tuple = AXES) -> list[list[int]]:
    """The rank lists of the groups along ``axis`` of a mesh of ``axes``,
    ordered by the other coordinates (row-major); each list is in the
    axis' coordinate order."""
    k = axes.index(axis)
    others = [range(n) for i, n in enumerate(shape) if i != k]
    out = []
    for rest in itertools.product(*others):
        ranks = []
        for c in range(shape[k]):
            coords = list(rest)
            coords.insert(k, c)
            ranks.append(mesh_rank(coords, shape))
        out.append(ranks)
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: its rank, the axis sizes, the
    axis names (the pod mesh's, the pipe mesh's or the seq mesh's), and
    its process group along each axis (``None``: this process alone, no
    ``torch.distributed``)."""

    shape: tuple = (1, 1, 1)
    rank: int = 0
    groups: dict | None = None
    axes: tuple = AXES

    def __post_init__(self):
        if self.axes not in (AXES, PIPE_AXES, SP_AXES):
            raise ValueError(f"mesh axes {self.axes}: want {AXES}, "
                             f"{PIPE_AXES} or {SP_AXES}")
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} for axes {self.axes}")
        if self.groups is None:
            object.__setattr__(self, "groups", dict.fromkeys(self.axes))

    @property
    def coords(self) -> tuple:
        return mesh_coords(self.rank, self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]

    @property
    def fsdp_axes(self) -> tuple:
        """The axes that shard weights and the batch, outermost first:
        ``("pod", "data")`` on the pod mesh, ``("data",)`` on the pipe
        mesh."""
        return tuple(a for a in self.axes
                     if a not in (TP_AXIS, PIPE_AXIS, SP_AXIS))

    @property
    def fsdp_groups(self) -> tuple:
        return tuple(self.groups[a] for a in self.fsdp_axes)

    @property
    def fsdp_rank(self) -> int:
        """This rank's fsdp index, outermost axis major."""
        r = 0
        for a in self.fsdp_axes:
            r = r * self.size(a) + self.index(a)
        return r

    def parallel_ctx(self, plan, sp_mode: str = "ulysses") -> ParallelCtx:
        """The ``ParallelCtx`` of this rank under the comm ``plan``; on the
        seq mesh its seq group (a group of one rank included) with the
        attention flavour ``sp_mode``."""
        return ParallelCtx(plan=plan, group=self.groups[TP_AXIS],
                           fsdp_groups=self.fsdp_groups,
                           fsdp_axes=self.fsdp_axes,
                           pipe_group=self.groups.get(PIPE_AXIS),
                           sp_group=self.groups.get(SP_AXIS),
                           sp_mode=sp_mode)

    def model_kwargs(self) -> dict:
        """This rank's place as ``models.model.Model`` takes it."""
        pipe, seq = PIPE_AXIS in self.axes, SP_AXIS in self.axes
        return {"tp_rank": self.index(TP_AXIS), "fsdp_rank": self.fsdp_rank,
                "fsdp_axes": self.fsdp_axes,
                "pipe": self.size(PIPE_AXIS) if pipe else 1,
                "pipe_rank": self.index(PIPE_AXIS) if pipe else 0,
                "sp_axis": SP_AXIS if seq else None,
                "sp": self.size(SP_AXIS) if seq else 1,
                "sp_rank": self.index(SP_AXIS) if seq else 0}


def init_mesh(shape, device, *, axes: tuple = AXES,
              init_method: str = "env://", world_size: int | None = None,
              rank: int | None = None, timeout_s: float = 600.0) -> Mesh:
    """Join (or start) the default process group — NCCL for a CUDA device,
    gloo for the CPU (``parallel.init_tp_group``) — and create the mesh's
    groups along every axis, a group of one rank included, so that every
    hop goes through ``torch.distributed``.  ``axes`` picks the pod mesh
    (:data:`AXES`), the pipe mesh (:data:`PIPE_AXES`) or the seq mesh
    (:data:`SP_AXES`).  The world must hold the product of ``shape``
    ranks."""
    shape = tuple(int(v) for v in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    init_tp_group(device, init_method=init_method, world_size=world_size,
                  rank=rank, timeout_s=timeout_s)
    world, me = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)}"
                         f" ranks, the process group has {world}")
    groups = {}
    for axis in reversed(axes):                 # the same order on every rank
        for ranks in axis_ranks(shape, axis, axes):
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = g
    return Mesh(shape, me, groups, axes)


def make_production_mesh(*, multi_pod: bool = False, sp: int = 1) -> Mesh:
    """The production mesh of the JAX package's ``make_production_mesh``
    as a :class:`Mesh` of no process groups (a shape to plan against,
    e.g. the dry run's; nothing joins a process group): single-pod ``(1,
    16, 16)`` over :data:`AXES` (256 ranks; the JAX mesh ``(16, 16)``
    over ``("data", "model")``), multi-pod ``(2, 16, 16)`` (512 ranks).
    ``sp > 1`` carves a ``seq`` axis of ``sp`` ranks out of data (the
    seq mesh :data:`SP_AXES`, the world unchanged)."""
    shape, axes = (2 if multi_pod else 1, 16, 16), AXES
    if sp > 1:
        if shape[1] % sp:
            raise ValueError(f"sp={sp} does not divide data axis {shape[1]}")
        shape, axes = (shape[0], shape[1] // sp, sp, shape[2]), SP_AXES
    return Mesh(shape, 0, None, axes)


def mesh_axis_info(mesh: Mesh):
    """(fsdp_axes, tp_axis, tp, fsdp_size) of a mesh (the JAX package's
    ``launch/mesh.py`` ``mesh_axis_info`` on the pod mesh; on the pipe mesh
    the fsdp axes are ``("data",)``, as the JAX package's pipeline check
    passes them; the seq axis is neither fsdp nor TP: see
    :func:`sp_axis_info`); the groups are ``mesh.groups[axis]``."""
    fsdp = 1
    for a in mesh.fsdp_axes:
        fsdp *= mesh.size(a)
    return mesh.fsdp_axes, TP_AXIS, mesh.size(TP_AXIS), fsdp


def sp_axis_info(mesh: Mesh):
    """(seq axis name or None, its size): a seq axis of size 1 counts as
    inactive, as the JAX package's ``sp_axis_info`` has it."""
    if SP_AXIS in mesh.axes and mesh.size(SP_AXIS) > 1:
        return SP_AXIS, mesh.size(SP_AXIS)
    return None, 1
