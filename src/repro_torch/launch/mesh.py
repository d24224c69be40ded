"""The ``pod x data x model`` process mesh: rank layout and process groups.

Rank ``r`` of a ``(pod, data, model)`` mesh sits at the row-major
coordinates of ``r``, the model axis fastest — the device order that
``jax.make_mesh((pod, data, model), ("pod", "data", "model"))`` gives the
JAX package.  So the ranks of one TP group are neighbours, and the fsdp
index of a rank (its shard of an fsdp-sharded weight and its rows of the
batch) is ``pod * data + data_index``, pod-major as the JAX package's
``PartitionSpec(("pod", "data"))`` shards.

:func:`init_mesh` builds one family of process groups per axis: each
group holds the ranks that differ only in that axis' coordinate.  Every
rank creates every group, in the same order (model, data, pod; within a
family, by the other coordinates in row-major order): ``new_group`` is a
collective call of the whole world, and ranks that create groups in
another order hang.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch.distributed as dist

from repro_torch.core.parallel import (FSDP_AXES, TP_AXIS, ParallelCtx,
                                       init_tp_group)

AXES = FSDP_AXES + (TP_AXIS,)


def parse_mesh(text: str) -> tuple[int, int, int]:
    """``"pod,data,model"`` -> the three axis sizes."""
    shape = tuple(int(v) for v in text.split(","))
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: want pod,data,model sizes >= 1")
    return shape


def mesh_coords(rank: int, shape) -> tuple[int, int, int]:
    """Row-major coordinates of ``rank`` (model fastest)."""
    pod, data, model = shape
    if not 0 <= rank < pod * data * model:
        raise ValueError(f"rank {rank} outside a {shape} mesh")
    return rank // (data * model), rank // model % data, rank % model


def mesh_rank(coords, shape) -> int:
    """Inverse of :func:`mesh_coords`."""
    p, d, m = coords
    return (p * shape[1] + d) * shape[2] + m


def axis_ranks(shape, axis: str) -> list[list[int]]:
    """The rank lists of the groups along ``axis``, ordered by the other
    coordinates (row-major); each list is in the axis' coordinate order."""
    k = AXES.index(axis)
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
    """This process's place in the mesh: its rank, the axis sizes, and its
    process group along each axis (``None``: this process alone, no
    ``torch.distributed``)."""

    shape: tuple = (1, 1, 1)
    rank: int = 0
    groups: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(AXES))

    @property
    def coords(self) -> tuple[int, int, int]:
        return mesh_coords(self.rank, self.shape)

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    @property
    def fsdp_groups(self) -> tuple:
        return tuple(self.groups[a] for a in FSDP_AXES)

    def parallel_ctx(self, plan) -> ParallelCtx:
        """The ``ParallelCtx`` of this rank under the comm ``plan``."""
        return ParallelCtx(plan=plan, group=self.groups[TP_AXIS],
                           fsdp_groups=self.fsdp_groups)


def init_mesh(shape, device, *, init_method: str = "env://",
              world_size: int | None = None, rank: int | None = None,
              timeout_s: float = 600.0) -> Mesh:
    """Join (or start) the default process group — NCCL for a CUDA device,
    gloo for the CPU (``parallel.init_tp_group``) — and create the mesh's
    groups along every axis, a group of one rank included, so that every
    hop goes through ``torch.distributed``.  The world must hold
    ``pod * data * model`` ranks."""
    shape = tuple(int(v) for v in shape)
    init_tp_group(device, init_method=init_method, world_size=world_size,
                  rank=rank, timeout_s=timeout_s)
    world, me = dist.get_world_size(), dist.get_rank()
    if world != shape[0] * shape[1] * shape[2]:
        raise ValueError(f"mesh {shape} needs {shape[0] * shape[1] * shape[2]}"
                         f" ranks, the process group has {world}")
    groups = {}
    for axis in (TP_AXIS, "data", "pod"):       # the same order on every rank
        for ranks in axis_ranks(shape, axis):
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = g
    return Mesh(shape, me, groups)


def mesh_axis_info(mesh: Mesh):
    """(fsdp_axes, tp_axis, tp, fsdp_size) of a mesh (the JAX package's
    ``launch/mesh.py`` ``mesh_axis_info``); the groups are
    ``mesh.groups[axis]``."""
    fsdp = 1
    for a in FSDP_AXES:
        fsdp *= mesh.size(a)
    return FSDP_AXES, TP_AXIS, mesh.size(TP_AXIS), fsdp
