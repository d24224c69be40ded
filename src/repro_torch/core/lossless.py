"""Lossless wire stages: zero-run compaction (and entropy accounting) over
a base codec's packed wire buffer — the JAX package's
``repro/core/lossless.py``.

``zle`` — zero-length encoding.  The inner codec's wire row (payload +
scales + alpha, ``W`` bytes) is viewed as ``G = ceil(W/g)`` groups of
``g`` bytes (the spec arg ``zle:g=<N>``, default 16); a ``G``-bit
occupancy bitmap marks the nonzero groups, and the nonzero groups are
stably compacted to the front of a max-size data region.  The slot is
bounded-but-ragged (``codecs.WireLayout`` with ``variable=True``)::

    byte offset   component                     semantics
    0             length   uint32 x 1           achieved slot bytes
    4             bitmap   uint8  x ceil(G/8)   nonzero-group occupancy
    4+ceil(G/8)   data     uint8  x g*G         compacted nonzero groups,
                                                zero-padded to the bound

The static slot width is ``4 + ceil(G/8) + g*G`` bytes, the achieved width
``4 + ceil(G/8) + g*nnz``.  Every byte past the achieved width is zero,
so a wire truncated to any width that covers it and zero-repadded decodes
to the same bytes — the contract of the transport's negotiated slots
(``collectives.SlotController``).  The bytes are the JAX package's, so a
ZLE wire written by one package decodes in the other.

Encode and decode are plain PyTorch on the tensor's device, free of host
syncs: the compaction scatters each nonzero group to its rank among the
nonzero groups of its row (a cumulative sum), the decode gathers it back.

:class:`ZleCodec` stacks the stage over any codec that publishes a wire
layout (``taco+zle:folded:chunks=4``).  It runs through the inner codec's
wire paths, so TACO's kernels still emit and read the inner buffer.  The
length header is telemetry: decode reads only the bitmap and the data.

``byte_entropy_bits`` is the order-0 Shannon bound (bits/byte) of a wire
buffer, what an ideal range coder would reach on top of ZLE (accounting
only).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.codecs import WireFastPath, make_wire_layout
from repro_torch.core.overlap import PIPELINED

__all__ = [
    "GROUP_BYTES", "SLOT_MODES", "zle_wire_layout", "zle_encode",
    "zle_decode", "zle_slot_bytes", "byte_entropy_bits", "ZleCodec",
]

#: Default bytes per zero-run group (spec arg ``zle:g=<N>``).
GROUP_BYTES = 16

#: Valid values of the ``slot=`` spec arg: "static" moves the worst-case
#: bound on every hop, "auto" opts into the transport's slot
#: renegotiation (``collectives.SlotController``).
SLOT_MODES = ("static", "auto")


def _geometry(inner_bytes: int, group: int = GROUP_BYTES) -> tuple[int, int]:
    """(groups, bitmap_bytes) of an ``inner_bytes`` inner wire row split
    into ``group``-byte zero-run groups."""
    if inner_bytes <= 0:
        raise ValueError(f"inner wire width must be >= 1, got {inner_bytes}")
    if group < 1:
        raise ValueError(f"zle group size must be >= 1, got {group}")
    groups = -(-inner_bytes // group)
    return groups, -(-groups // 8)


def zle_wire_layout(inner_bytes: int, group: int = GROUP_BYTES):
    """The variable :class:`~repro_torch.core.codecs.WireLayout` of one ZLE
    slot over an ``inner_bytes``-wide inner wire row."""
    groups, bitmap = _geometry(inner_bytes, group)
    return make_wire_layout(("length", "uint32", 1),
                            ("bitmap", "uint8", bitmap),
                            ("data", "uint8", groups * group),
                            variable=True)


def zle_slot_bytes(inner_bytes: int, group: int = GROUP_BYTES) -> int:
    """Static slot (worst-case) bytes of the ZLE stage over an
    ``inner_bytes`` inner row: header + bitmap + group-padded data."""
    return zle_wire_layout(inner_bytes, group).total_bytes


def zle_encode(wire: torch.Tensor, group: int = GROUP_BYTES):
    """Inner wire rows ``(..., W)`` uint8 -> ``(length, bitmap, data)``:
    ``(..., 1)`` uint32, ``(..., ceil(G/8))`` uint8 (LSB first) and
    ``(..., g*G)`` uint8 (nonzero groups in order at the front, the rest
    zero), as :func:`zle_wire_layout` lays them out."""
    lead, w = wire.shape[:-1], wire.shape[-1]
    groups, bitmap_bytes = _geometry(w, group)
    rows = int(np.prod(lead)) if lead else 1
    g = torch.nn.functional.pad(wire.reshape(rows, w),
                                (0, groups * group - w))
    g = g.reshape(rows, groups, group)
    nz = (g != 0).any(dim=-1)                                # (R, G)
    bits = torch.nn.functional.pad(nz.to(torch.int32),
                                   (0, bitmap_bytes * 8 - groups))
    weights = 1 << torch.arange(8, device=wire.device, dtype=torch.int32)
    bitmap = (bits.reshape(rows, bitmap_bytes, 8) * weights).sum(-1)
    # stable front compaction: nonzero group i goes to its rank among the
    # row's nonzero groups; zero groups go to a spare slot G, cut off
    rank = torch.cumsum(nz, dim=-1) - 1
    dest = torch.where(nz, rank, torch.full_like(rank, groups))
    data = torch.zeros((rows, groups + 1, group), dtype=torch.uint8,
                       device=wire.device)
    data.scatter_(1, dest[..., None].expand(-1, -1, group), g)
    nnz = nz.sum(dim=-1)
    length = (4 + bitmap_bytes + nnz * group).to(torch.int32) \
        .view(torch.uint32)             # a view: no uint32 arithmetic
    return (length.reshape(*lead, 1),
            bitmap.to(torch.uint8).reshape(*lead, bitmap_bytes),
            data[:, :groups].reshape(*lead, groups * group))


def zle_decode(bitmap: torch.Tensor, data: torch.Tensor, inner_bytes: int,
               group: int = GROUP_BYTES) -> torch.Tensor:
    """Inverse of :func:`zle_encode`: ``(..., W)`` uint8 inner wire rows
    from the bitmap and the compacted data (the length header is not
    read: ``nnz`` is the bitmap's popcount)."""
    lead = bitmap.shape[:-1]
    groups, bitmap_bytes = _geometry(inner_bytes, group)
    rows = int(np.prod(lead)) if lead else 1
    shifts = torch.arange(8, device=bitmap.device, dtype=torch.uint8)
    bits = (bitmap.reshape(rows, bitmap_bytes, 1) >> shifts) & 1
    nz = bits.reshape(rows, bitmap_bytes * 8)[:, :groups].bool()
    src = torch.clamp(torch.cumsum(nz, dim=-1) - 1, 0, groups - 1)
    g = torch.gather(data.reshape(rows, groups, group), 1,
                     src[..., None].expand(-1, -1, group))
    g = torch.where(nz[..., None], g, torch.zeros((), dtype=torch.uint8,
                                                  device=g.device))
    return g.reshape(*lead, groups * group)[..., :inner_bytes]


def byte_entropy_bits(wire: torch.Tensor) -> torch.Tensor:
    """Order-0 Shannon entropy (bits/byte) of a uint8 buffer, a 0-d f32
    tensor: the ideal range-coder bound on top of ZLE (accounting only)."""
    flat = wire.reshape(-1)
    counts = torch.bincount(flat.to(torch.int64), minlength=256).float()
    p = counts / flat.numel()
    safe = torch.where(p > 0, p, torch.ones_like(p))
    return -torch.sum(torch.where(p > 0, p * torch.log2(safe),
                                  torch.zeros_like(p)))


@dataclasses.dataclass(frozen=True)
class ZleCodec(WireFastPath):
    """Hybrid stack: ``inner`` lossy codec + the lossless ZLE wire stage.

    The encoded components are ``(length, bitmap, data)`` over the inner
    codec's PACKED wire row (``inner.encode_wire``, so TACO's kernels
    still emit it); decode rebuilds the inner row and hands it to the
    inner codec's wire decoders.  ``granule``, ``chunks``, ``schedule``
    and the escalation policy (``escalate`` / ``hold``, parsed into the
    inner codec) come from the inner codec.

    ``group`` is the compaction granularity (``zle:g=<N>``); ``slot`` /
    ``headroom`` opt the stack into slot renegotiation
    (``zle:slot=auto:headroom=<f>``); ``moved_frac`` is the negotiated
    per-chunk moved fraction of the slot bound, set only by the
    controller (never from a spec; ``None`` moves the full bound)."""

    inner: object
    group: int = GROUP_BYTES
    slot: str = "static"
    headroom: float = 0.5
    moved_frac: tuple | None = None

    def __post_init__(self):
        if self.group < 1:
            raise ValueError(f"zle group size must be >= 1, got {self.group}")
        if self.slot not in SLOT_MODES:
            raise ValueError(f"zle slot mode must be one of "
                             f"{'/'.join(SLOT_MODES)}, got {self.slot!r}")
        if self.headroom < 0:
            raise ValueError(f"zle headroom must be >= 0, "
                             f"got {self.headroom}")
        if self.moved_frac is not None:
            if self.slot != "auto":
                raise ValueError("moved_frac is controller-owned and only "
                                 "valid under slot='auto'")
            if not self.moved_frac or any(
                    not 0.0 < f <= 1.0 for f in self.moved_frac):
                raise ValueError("moved_frac must be a non-empty tuple of "
                                 f"fractions in (0, 1], got "
                                 f"{self.moved_frac}")

    @property
    def granule(self) -> int:
        return self.inner.granule

    @property
    def chunks(self) -> int:
        return int(getattr(self.inner, "chunks", 1))

    @property
    def schedule(self) -> str:
        return getattr(self.inner, "schedule", PIPELINED)

    @property
    def escalate(self):
        return getattr(self.inner, "escalate", None)

    @property
    def hold(self) -> int:
        return int(getattr(self.inner, "hold", 1))

    def _inner_bytes(self, n: int) -> int:
        return self.inner.wire_layout(n).total_bytes

    def wire_layout(self, n):
        return zle_wire_layout(self._inner_bytes(n), self.group)

    def encode(self, x):
        return zle_encode(self.inner.encode_wire(x), self.group)

    def decode(self, enc, n, dtype):
        _, bitmap, data = enc
        inner_wire = zle_decode(bitmap, data, self._inner_bytes(n),
                                self.group)
        return self.inner.decode_wire(inner_wire, n, dtype)

    def decode_sum(self, enc, n, dtype):
        _, bitmap, data = enc
        inner_wire = zle_decode(bitmap, data, self._inner_bytes(n),
                                self.group)
        return self.inner.decode_sum_wire(inner_wire, n, dtype)

    def bytes_per_element(self, in_dtype=torch.bfloat16) -> float:
        # the asymptotic slot bound: inner bytes + one bitmap bit a group
        return float(self.inner.bytes_per_element(in_dtype)) \
            * (1.0 + 1.0 / (8 * self.group))

    def expansion_bytes(self, n: int) -> int:
        """Worst-case slot growth over the inner wire row (header + bitmap
        + group padding) for an ``n``-element slot."""
        w = self._inner_bytes(n)
        return zle_slot_bytes(w, self.group) - w


def _np_reference_zle(row: np.ndarray,
                      group: int = GROUP_BYTES) -> tuple[int, np.ndarray]:
    """Tiny numpy oracle for tests: (achieved_bytes, decoded_row)."""
    w = row.size
    groups, bitmap_bytes = _geometry(w, group)
    padded = np.zeros(groups * group, np.uint8)
    padded[:w] = row
    g = padded.reshape(groups, group)
    nnz = int(np.sum(np.any(g != 0, axis=-1)))
    return 4 + bitmap_bytes + nnz * group, padded[:w]
