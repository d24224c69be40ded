"""Wire codecs ported so far: ``IdentityCodec`` (the uncompressed
baseline), ``TacoCodec`` (the paper's compressor on the TP path),
``Sdp4BitCodec`` (SDP4bit's int4 gradient codec on the DP / fsdp path),
``TahQuantCodec`` (per-group int8 at the pipeline stage boundaries) and
``Int8Codec`` (per-group int8 for the fsdp weight gather).

Codecs operate on 2-D ``(slots, n)`` tensors with ``n`` a multiple of
``granule``.  ``encode`` returns the tuple of wire components,
``decode`` inverts it and ``decode_sum`` reduces a stacked peer axis.

Every compressing codec publishes a :class:`WireLayout` — the byte
offsets and dtypes of its encoded components in one slot — and the
transport moves all components as ONE contiguous uint8 buffer per hop.
The layout is the JAX package's, byte for byte, so a wire row written by
one package decodes in the other.  The transport produces and consumes
that buffer through ``encode_wire`` / ``decode_wire`` /
``decode_sum_wire``: the generic :class:`WireFastPath` is
pack/unpack composed with encode/decode and defines the format, while
``TacoCodec`` sends a slot that ``kops.wire_kernel_impl`` admits to the
fused wire kernels and a larger one (a training hop) to the block kernels
composed with pack/unpack — the JAX package's route.  Either way each
operator runs its plain version on the CPU and its CUDA kernel on the
card.  ``Sdp4BitCodec``, ``TahQuantCodec`` and ``Int8Codec`` are the
generic composition over the plain PyTorch of ``core/dp_compress.py`` and
``core/pp_compress.py`` on either device: the JAX package has no Pallas
kernel for them.

A slot may be *bounded-but-ragged*: a layout with ``variable=True`` (the
lossless stage, ``core/lossless.py``) still moves ``total_bytes`` — the
worst-case bound — but only a data-dependent prefix carries information,
recorded in a uint32 length header at byte offset 0
(:func:`achieved_wire_bytes` reads it back).

Every lossy codec carries the error-escalation policy fields
(``escalate=<fallback>@<threshold>`` / ``hold=<N>``, ``core/policy.py``);
``escalate=None``, the default, adds no probe op to a hop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dp_compress, pp_compress
from repro_torch.core import taco as taco_mod
# the ring's stage orders (the ``schedule=`` spec token of chunked codecs)
from repro_torch.core.overlap import PIPELINED, SCHEDULES
from repro_torch.core.taco import TacoConfig
from repro_torch.kernels import ops as kops

__all__ = [
    "IdentityCodec", "TacoCodec", "Sdp4BitCodec", "TahQuantCodec",
    "Int8Codec", "WireComponent",
    "WireLayout", "make_wire_layout", "achieved_wire_bytes", "pack_wire",
    "unpack_wire", "WireFastPath", "wire_bytes_per_element", "PIPELINED",
    "SCHEDULES", "DEFAULT_HOLD",
]


_TORCH_DTYPES = {"uint8": torch.uint8, "int8": torch.int8,
                 "uint32": torch.uint32, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class WireComponent:
    """One encoded component inside the packed wire buffer: ``size``
    elements of ``dtype`` (a numpy dtype name) starting at byte
    ``offset`` of the slot's contiguous uint8 wire row."""

    name: str
    dtype: str
    size: int
    offset: int

    @property
    def itemsize(self) -> int:
        return np.dtype(self.dtype).itemsize

    @property
    def nbytes(self) -> int:
        return self.size * self.itemsize


@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Per-slot wire format: components in ``encode`` output order,
    densely packed (offset_i+1 == offset_i + nbytes_i).

    ``total_bytes`` is always the static slot width, the size of the
    buffer a hop moves.  ``variable=True`` declares a bounded-but-ragged
    slot: its first component must be a one-element uint32 length header
    at byte offset 0 recording the achieved bytes, and every byte past
    them is zero."""

    components: tuple
    variable: bool = False

    @property
    def total_bytes(self) -> int:
        if not self.components:
            return 0
        last = self.components[-1]
        return last.offset + last.nbytes

    def __post_init__(self):
        if self.variable:
            c0 = self.components[0] if self.components else None
            if c0 is None or c0.offset != 0 or c0.dtype != "uint32" \
                    or c0.size != 1:
                raise ValueError(
                    "variable WireLayout requires a 1-element uint32 "
                    "length header as its first component (offset 0)")


def make_wire_layout(*comps, variable: bool = False) -> WireLayout:
    """Dense :class:`WireLayout` from ``(name, dtype, size)`` triples
    (``variable``: a bounded-but-ragged slot, see :class:`WireLayout`)."""
    out, off = [], 0
    for name, dtype, size in comps:
        c = WireComponent(name, np.dtype(dtype).name, int(size), off)
        out.append(c)
        off += c.nbytes
    return WireLayout(tuple(out), variable=variable)


def achieved_wire_bytes_i64(wire: torch.Tensor,
                            layout: WireLayout) -> torch.Tensor:
    """:func:`achieved_wire_bytes` as int64 (PyTorch computes little in
    uint32, on the card least of all)."""
    if not layout.variable:
        return torch.full(wire.shape[:-1], layout.total_bytes,
                          dtype=torch.int64, device=wire.device)
    b = wire[..., 0:4].to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def achieved_wire_bytes(wire: torch.Tensor,
                        layout: WireLayout) -> torch.Tensor:
    """Per-slot achieved bytes of a packed wire buffer ``(...,
    total_bytes)``: a ``(...,)`` uint32 tensor.  A variable layout's
    length header is read byte by byte (little-endian), so a wire that is
    a view at any byte offset reads; on a static layout every slot
    achieves its full ``total_bytes``."""
    return achieved_wire_bytes_i64(wire, layout).to(torch.int32) \
        .view(torch.uint32)


def _to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Reinterpret a component's trailing dim as uint8 bytes
    (little-endian, as the JAX bitcast)."""
    return a.contiguous().view(torch.uint8)


def pack_wire(enc, layout: WireLayout) -> torch.Tensor:
    """Encoded component tuple -> ONE contiguous uint8 buffer per slot,
    laid out per ``layout``.  The width checks catch an encode/layout
    disagreement before bytes are shipped."""
    if len(enc) != len(layout.components):
        raise ValueError(f"encode produced {len(enc)} components, layout "
                         f"declares {len(layout.components)}")
    parts = []
    for a, comp in zip(enc, layout.components):
        b = _to_bytes(a)
        if b.shape[-1] != comp.nbytes:
            raise ValueError(
                f"component {comp.name!r}: encode emitted {b.shape[-1]} "
                f"bytes/slot, layout declares {comp.nbytes}")
        parts.append(b)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def unpack_wire(wire: torch.Tensor, layout: WireLayout) -> tuple:
    """Inverse of :func:`pack_wire`: slice the uint8 buffer at the static
    byte offsets and reinterpret each component (any leading axes).  A
    field that does not start at a multiple of its element size (a wire
    view at an odd byte offset) or whose row stride is not one (a single
    row of a slot width that is not a multiple of it) is copied first, so
    any view decodes."""
    out = []
    for c in layout.components:
        dtype = _TORCH_DTYPES[c.dtype]
        field = wire[..., c.offset:c.offset + c.nbytes].contiguous()
        if field.storage_offset() % dtype.itemsize or \
                any(st % dtype.itemsize for st in field.stride()[:-1]):
            field = field.clone(memory_format=torch.contiguous_format)
        out.append(field.view(dtype))
    return tuple(out)


#: Default de-escalation hysteresis window (steps) of ``escalate=``
#: codecs, shared by the dataclass fields and the spec normaliser.
DEFAULT_HOLD = 20


def _check_escalation(codec) -> None:
    """Validate the ``escalate`` / ``hold`` fields of a lossy codec (the
    registry checks the fallback NAME against its fallback table)."""
    esc = getattr(codec, "escalate", None)
    hold = getattr(codec, "hold", DEFAULT_HOLD)
    if not isinstance(hold, int) or hold < 1:
        raise ValueError(f"escalation hold must be an int >= 1, got {hold!r}")
    if esc is None:
        return
    if (not isinstance(esc, tuple) or len(esc) != 2
            or not isinstance(esc[0], str) or not esc[0]):
        raise ValueError("escalate must be a (fallback_name, threshold) "
                         f"tuple, got {esc!r}")
    thr = float(esc[1])
    if not thr > 0.0:
        raise ValueError(f"escalation threshold must be > 0, got {thr}")


class WireFastPath:
    """Generic wire-native paths: pack/unpack composed with encode/decode.
    These define the wire byte format; ``TacoCodec`` overrides them with
    the fused kernels, which must write and read the same bytes."""

    def __post_init__(self):
        _check_escalation(self)

    def encode_wire(self, x):
        """(slots, n) -> (slots, total_bytes) uint8 wire buffer."""
        return pack_wire(self.encode(x), self.wire_layout(x.shape[-1]))

    def decode_wire(self, wire, n, dtype):
        """(..., total_bytes) uint8 -> (..., n) decoded in ``dtype``."""
        return self.decode(unpack_wire(wire, self.wire_layout(n)), n, dtype)

    def decode_sum_wire(self, wire, n, dtype):
        """(P, ..., total_bytes) uint8 -> peer-summed decode."""
        return self.decode_sum(unpack_wire(wire, self.wire_layout(n)),
                               n, dtype)


@dataclasses.dataclass(frozen=True)
class IdentityCodec:
    """No compression: collectives move the raw tensor."""

    granule: int = 1
    chunks: int = 1

    def wire_layout(self, n):
        return None

    def encode_wire(self, x):
        raise TypeError("IdentityCodec moves the raw tensor and has no "
                        "wire form (wire_layout() is None)")

    def decode_wire(self, wire, n, dtype):
        raise TypeError("IdentityCodec has no wire form")

    def decode_sum_wire(self, wire, n, dtype):
        raise TypeError("IdentityCodec has no wire form")

    def encode(self, x):
        return (x,)

    def decode(self, enc, n, dtype):
        return enc[0].to(dtype)

    def decode_sum(self, enc, n, dtype):
        # accumulate the peer axis in f32, not in the bf16 wire dtype
        x = enc[0]
        if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
            x = x.float()
        return x.sum(dim=0).to(dtype)

    def bytes_per_element(self, in_dtype=torch.bfloat16) -> float:
        return float(torch.empty((), dtype=in_dtype).element_size())


@dataclasses.dataclass(frozen=True)
class TacoCodec(WireFastPath):
    """The paper's compressor: payload uint8 (fp8 bits) / int8 + scales."""

    cfg: TacoConfig = TacoConfig()
    chunks: int = 1
    schedule: str = PIPELINED
    escalate: tuple | None = None   # (fallback_name, error threshold)
    hold: int = DEFAULT_HOLD

    @property
    def granule(self) -> int:
        return self.cfg.block_size

    def wire_layout(self, n):
        return make_wire_layout(*taco_mod.wire_components(self.cfg, n))

    def _groups(self):
        b = self.cfg.block_size
        return b // (self.cfg.quant_group_size or b)

    def encode(self, x):
        slots, n = x.shape
        b = self.cfg.block_size
        mb = n // b
        q, alpha, s = kops.compress_blocks(x.reshape(slots * mb, b), self.cfg)
        payload = taco_mod._storage_to_wire(q, self.cfg.format_spec)
        payload = payload.reshape(slots, n)
        groups = s.shape[-1]
        if self.cfg.metadata == "folded":
            return payload, (s / alpha[:, None]).reshape(slots, mb * groups)
        return payload, s.reshape(slots, mb * groups), alpha.reshape(slots, mb)

    def _fields(self, enc):
        if self.cfg.metadata == "folded":
            payload, s = enc
            return payload, s, None
        return enc

    def decode(self, enc, n, dtype):
        payload, s, alpha = self._fields(enc)
        slots = payload.shape[0]
        b = self.cfg.block_size
        m = slots * (n // b)
        q = taco_mod._wire_to_storage(payload.reshape(m, b),
                                      self.cfg.format_spec)
        s = s.reshape(m, self._groups())
        alpha = None if alpha is None else alpha.reshape(m)
        out = kops.decompress_blocks(q, s, alpha, self.cfg)
        return out.reshape(slots, n).to(dtype)

    def decode_sum(self, enc, n, dtype):
        payload, s, alpha = self._fields(enc)
        p = payload.shape[0]
        b = self.cfg.block_size
        m = (payload.numel() // p) // b
        q = taco_mod._wire_to_storage(payload.reshape(p, m, b),
                                      self.cfg.format_spec)
        s = s.reshape(p, m, self._groups())
        alpha = None if alpha is None else alpha.reshape(p, m)
        out = kops.decompress_reduce(q, s, alpha, self.cfg)
        return out.reshape(-1)[:n].to(dtype)

    def bytes_per_element(self, in_dtype=torch.bfloat16) -> float:
        groups = self._groups()
        scalars = groups + (0 if self.cfg.metadata == "folded" else 1)
        return 1.0 + 4.0 * scalars / self.cfg.block_size

    # ---- fused wire-native paths: the wire kernels up to the slot budget,
    # pack/unpack over the block kernels above it ----------------------------
    def encode_wire(self, x):
        if kops.wire_kernel_impl(self.cfg, x.shape[-1]) is not None:
            return kops.compress_wire(x, self.cfg)
        return super().encode_wire(x)

    def decode_wire(self, wire, n, dtype):
        if kops.wire_kernel_impl(self.cfg, n) is not None:
            lead = wire.shape[:-1]
            out = kops.decompress_wire(wire.reshape(-1, wire.shape[-1]), n,
                                       self.cfg)
            return out.reshape(*lead, n).to(dtype)
        return super().decode_wire(wire, n, dtype)

    def decode_sum_wire(self, wire, n, dtype):
        """(P, total_bytes) peer stack -> (n,) peer sum in ``dtype``.  The
        budget applies to the whole stack (P·n), as in the JAX package;
        other stackings take the generic unpack path."""
        if wire.dim() == 2 and \
                kops.wire_kernel_impl(self.cfg, wire.shape[0] * n) is not None:
            out = kops.decompress_reduce_wire(wire, n, self.cfg)
            return out.reshape(-1)[:n].to(dtype)
        return super().decode_sum_wire(wire, n, dtype)


@dataclasses.dataclass(frozen=True)
class Sdp4BitCodec(WireFastPath):
    """SDP4bit: Hadamard-rotated per-block int4 + one f32 scale per block
    (``core/dp_compress.py``); wire ``payload`` uint8 n/2, then ``scale``
    f32 n/block."""

    block: int = 128
    rotate: bool = True
    chunks: int = 1
    schedule: str = PIPELINED
    escalate: tuple | None = None   # (fallback_name, error threshold)
    hold: int = DEFAULT_HOLD

    @property
    def granule(self) -> int:
        return self.block

    def wire_layout(self, n):
        return make_wire_layout(("payload", "uint8", n // 2),
                                ("scale", "float32", n // self.block))

    def encode(self, x):
        return dp_compress.compress_int4(x, self.block, self.rotate)

    def decode(self, enc, n, dtype):
        packed, s = enc
        return dp_compress.decompress_int4(packed, s, n, self.block,
                                           self.rotate, dtype)

    def decode_sum(self, enc, n, dtype):
        packed, s = enc
        return dp_compress.decompress_sum_int4(
            packed, s, n, self.block, self.rotate, dtype).reshape(-1)[:n]

    def bytes_per_element(self, in_dtype=torch.bfloat16) -> float:
        return 0.5 + 4.0 / self.block


class _GroupInt8(WireFastPath):
    """Per-group symmetric int8 + one f32 scale a group
    (``core/pp_compress.py``); wire ``payload`` int8 n, then ``scale`` f32
    n/group."""

    @property
    def granule(self) -> int:
        return self.group

    def wire_layout(self, n):
        return make_wire_layout(("payload", "int8", n),
                                ("scale", "float32", n // self.group))

    def encode(self, x):
        return pp_compress.compress_int8_group(x, self.group)

    def decode(self, enc, n, dtype):
        q, s = enc
        return pp_compress.decompress_int8_group(q, s, n, self.group, dtype)

    def decode_sum(self, enc, n, dtype):
        q, s = enc
        return pp_compress.decompress_sum_int8_group(
            q, s, n, self.group, dtype).reshape(-1)[:n]

    def bytes_per_element(self, in_dtype=torch.bfloat16) -> float:
        return 1.0 + 4.0 / self.group


@dataclasses.dataclass(frozen=True)
class TahQuantCodec(_GroupInt8):
    """TahQuant's fine-grained activation int8 (group 64) at the pipeline
    stage boundaries (``pp=tahquant``)."""

    group: int = 64
    chunks: int = 1
    schedule: str = PIPELINED
    escalate: tuple | None = None   # (fallback_name, error threshold)
    hold: int = DEFAULT_HOLD


@dataclasses.dataclass(frozen=True)
class Int8Codec(_GroupInt8):
    """Per-group int8 (group 128) for the fsdp weight all-gather
    (``weight_ag=int8``)."""

    group: int = 128
    chunks: int = 1
    schedule: str = PIPELINED
    escalate: tuple | None = None   # (fallback_name, error threshold)
    hold: int = DEFAULT_HOLD


def wire_bytes_per_element(codec, in_dtype=torch.bfloat16) -> float:
    return codec.bytes_per_element(in_dtype)
