"""The process meshes: rank layout and process groups.

Two meshes of three axes each, as the JAX package builds them:

  pod mesh  ``("pod", "data", "model")``: data parallelism and FSDP over
            pod x data, tensor parallelism over model (the train
            launcher's ``--mesh``);
  pipe mesh ``("pipe", "data", "model")``: pipeline stages over pipe,
            FSDP over data, tensor parallelism over model
            (``train/pipeline_parallel.py``, as the JAX package's
            ``tests/multidev/check_pipeline.py`` lays it out).

Rank ``r`` of a mesh sits at the row-major coordinates of ``r``, the
model axis fastest — the device order that ``jax.make_mesh(shape,
axes)`` gives the JAX package.  So the ranks of one TP group are
neighbours, and the fsdp index of a rank (its shard of an fsdp-sharded
weight and its rows of the batch) is ``pod * data + data_index`` on the
pod mesh, pod-major as the JAX package's ``PartitionSpec(("pod",
"data"))`` shards, and ``data_index`` on the pipe mesh.

:func:`init_mesh` builds one family of process groups per axis: each
group holds the ranks that differ only in that axis' coordinate.  Every
rank creates every group, in the same order (model, data, then pod or
pipe; within a family, by the other coordinates in row-major order):
``new_group`` is a collective call of the whole world, and ranks that
create groups in another order hang.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch.distributed as dist

from repro_torch.core.parallel import (FSDP_AXES, PIPE_AXIS, TP_AXIS,
                                       ParallelCtx, init_tp_group)

AXES = FSDP_AXES + (TP_AXIS,)                  # the pod mesh
PIPE_AXES = (PIPE_AXIS, "data", TP_AXIS)       # the pipe mesh


def parse_mesh(text: str) -> tuple[int, int, int]:
    """``"pod,data,model"`` (or ``"pipe,data,model"``) -> the three axis
    sizes."""
    shape = tuple(int(v) for v in text.split(","))
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: want three axis sizes >= 1")
    return shape


def mesh_coords(rank: int, shape) -> tuple[int, int, int]:
    """Row-major coordinates of ``rank`` (the last axis, model, fastest)."""
    pod, data, model = shape
    if not 0 <= rank < pod * data * model:
        raise ValueError(f"rank {rank} outside a {shape} mesh")
    return rank // (data * model), rank // model % data, rank % model


def mesh_rank(coords, shape) -> int:
    """Inverse of :func:`mesh_coords`."""
    p, d, m = coords
    return (p * shape[1] + d) * shape[2] + m


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
    axis names (the pod mesh's or the pipe mesh's), and its process group
    along each axis (``None``: this process alone, no
    ``torch.distributed``)."""

    shape: tuple = (1, 1, 1)
    rank: int = 0
    groups: dict | None = None
    axes: tuple = AXES

    def __post_init__(self):
        if self.axes not in (AXES, PIPE_AXES):
            raise ValueError(f"mesh axes {self.axes}: want {AXES} or "
                             f"{PIPE_AXES}")
        if self.groups is None:
            object.__setattr__(self, "groups", dict.fromkeys(self.axes))

    @property
    def coords(self) -> tuple[int, int, int]:
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
        return tuple(a for a in self.axes if a not in (TP_AXIS, PIPE_AXIS))

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

    def parallel_ctx(self, plan) -> ParallelCtx:
        """The ``ParallelCtx`` of this rank under the comm ``plan``."""
        return ParallelCtx(plan=plan, group=self.groups[TP_AXIS],
                           fsdp_groups=self.fsdp_groups,
                           fsdp_axes=self.fsdp_axes,
                           pipe_group=self.groups.get(PIPE_AXIS))

    def model_kwargs(self) -> dict:
        """This rank's place as ``models.model.Model`` takes it."""
        pipe = PIPE_AXIS in self.axes
        return {"tp_rank": self.index(TP_AXIS), "fsdp_rank": self.fsdp_rank,
                "fsdp_axes": self.fsdp_axes,
                "pipe": self.size(PIPE_AXIS) if pipe else 1,
                "pipe_rank": self.index(PIPE_AXIS) if pipe else 0}


def init_mesh(shape, device, *, axes: tuple = AXES,
              init_method: str = "env://", world_size: int | None = None,
              rank: int | None = None, timeout_s: float = 600.0) -> Mesh:
    """Join (or start) the default process group — NCCL for a CUDA device,
    gloo for the CPU (``parallel.init_tp_group``) — and create the mesh's
    groups along every axis, a group of one rank included, so that every
    hop goes through ``torch.distributed``.  ``axes`` picks the pod mesh
    (:data:`AXES`) or the pipe mesh (:data:`PIPE_AXES`).  The world must
    hold ``shape[0] * shape[1] * shape[2]`` ranks."""
    shape = tuple(int(v) for v in shape)
    axes = tuple(axes)
    init_tp_group(device, init_method=init_method, world_size=world_size,
                  rank=rank, timeout_s=timeout_s)
    world, me = dist.get_world_size(), dist.get_rank()
    if world != shape[0] * shape[1] * shape[2]:
        raise ValueError(f"mesh {shape} needs {shape[0] * shape[1] * shape[2]}"
                         f" ranks, the process group has {world}")
    groups = {}
    for axis in reversed(axes):                 # the same order on every rank
        for ranks in axis_ranks(shape, axis, axes):
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = g
    return Mesh(shape, me, groups, axes)


def mesh_axis_info(mesh: Mesh):
    """(fsdp_axes, tp_axis, tp, fsdp_size) of a mesh (the JAX package's
    ``launch/mesh.py`` ``mesh_axis_info`` on the pod mesh; on the pipe mesh
    the fsdp axes are ``("data",)``, as the JAX package's pipeline check
    passes them); the groups are ``mesh.groups[axis]``."""
    fsdp = 1
    for a in mesh.fsdp_axes:
        fsdp *= mesh.size(a)
    return mesh.fsdp_axes, TP_AXIS, mesh.size(TP_AXIS), fsdp
