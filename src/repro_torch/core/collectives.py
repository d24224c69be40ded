"""Compressed collectives — the paper's §4.4.2 communication layer.

Compression follows COCCL's two-shot decomposition, as the JAX package:

  ReduceScatter = one compressed all-to-all + ONE fused local reduction
  AllGather     = one compressed all-gather + fused decompress
  AllReduce     = ReduceScatter ∘ AllGather  (two compressions per round)

``_transport`` pads to the codec granule, encodes straight into ONE
packed uint8 wire buffer (``encode_wire``), moves it, and decodes straight
from the moved buffer (``decode_wire``, or ``decode_sum_wire`` when the
hop reduces).  Each hop therefore runs one compress operator on the sender
and one decompress (all-gather) or decompress-reduce (reduce-scatter)
operator on the receiver: the fused wire kernels for a slot inside the
codec's wire budget (decode hops), the block kernels for a larger one
(training hops).

Every collective takes a forward and a backward codec and is a
``torch.autograd.Function`` whose backward routes the cotangent through
the conjugate collective with the codec pair swapped, as the JAX
package's ``custom_vjp`` (quantization is straight-through: the quantizer
is not differentiated):

  Megatron-SP : ``all_gather_c`` fwd / ``psum_scatter_c`` bwd, and back
  AllReduce   : ``allreduce_g`` (fwd AR, bwd id) / ``copy_f`` (fwd id,
                bwd AR)

The move takes the group size.  At size 1 it is the identity on the wire
— as JAX's size-1 ``all_to_all`` / ``all_gather`` is — and encode and
decode still run.  Larger groups (the NCCL transport) and the chunked
ring (``chunks > 1``, ``core/overlap.py``) are the next slice and raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import IdentityCodec

Identity = IdentityCodec()


def _pad_to(x: torch.Tensor, mult: int):
    n = x.shape[-1]
    rem = (-n) % mult
    if rem:
        x = torch.nn.functional.pad(x, (0, rem))
    return x, n


def _check_group(group_size: int) -> None:
    if group_size != 1:
        raise NotImplementedError(
            f"compressed collectives over a group of {group_size}: the NCCL "
            "transport is the next slice of the port (group size 1 only)")


def _move(wire: torch.Tensor, group_size: int) -> torch.Tensor:
    """The collective that carries one packed wire buffer: at group size 1
    every peer is this process, so the buffer arrives unchanged."""
    _check_group(group_size)
    return wire


def _transport(x2d, codec, group_size, *, reduce=False, dtype):
    """Pad the trailing dim of ``x2d`` to the codec granule, encode into the
    packed wire buffer, move it, decode (fused peer sum when ``reduce``),
    and crop the padding."""
    if getattr(codec, "chunks", 1) > 1:
        raise NotImplementedError(
            "chunks>1 routes through the ring transport (core/overlap.py), "
            "which is the next slice of the port")
    padded, n = _pad_to(x2d, codec.granule)
    pn = padded.shape[-1]
    wire = _move(codec.encode_wire(padded), group_size)
    if reduce:
        return codec.decode_sum_wire(wire, pn, dtype)[:n]
    return codec.decode_wire(wire, pn, dtype)[..., :n]


def _rs_one(x, group_size, dim, codec):
    """One-axis compressed reduce-scatter along ``dim``: ONE compressed
    all-to-all, ONE fused local reduction."""
    if isinstance(codec, IdentityCodec):
        _check_group(group_size)
        return x
    moved = torch.movedim(x, dim, 0)
    d = moved.shape[0]
    if d % group_size:
        raise ValueError(
            f"compressed reduce-scatter: scatter dim {dim} has size {d}, "
            f"not divisible by the group size {group_size}")
    chunks = moved.reshape(group_size, -1)              # chunk i -> peer i
    summed = _transport(chunks, codec, group_size, reduce=True,
                        dtype=x.dtype)
    out = summed.reshape(d // group_size, *moved.shape[1:])
    return torch.movedim(out, 0, dim) if dim != 0 else out


def _ag_one(x, group_size, dim, codec):
    """One-axis compressed all-gather concatenating along ``dim``."""
    if isinstance(codec, IdentityCodec):
        _check_group(group_size)
        return x
    dec = _transport(x.reshape(1, -1), codec, group_size, dtype=x.dtype)
    dec = dec.reshape(group_size, *x.shape)                   # (P, ...)
    out = torch.movedim(dec, 0, dim)
    shape = list(x.shape)
    shape[dim] *= group_size
    return out.reshape(shape)


def _ag_impl(x, group_size, dim, codec):
    """All-gather over the TP group (one axis in the port; the JAX
    package's tuple axes gather innermost first)."""
    return _ag_one(x, group_size, dim, codec)


def _rs_impl(x, group_size, dim, codec):
    """Reduce-scatter over the TP group (the conjugate of
    :func:`_ag_impl`)."""
    return _rs_one(x, group_size, dim, codec)


def _ar_impl(x, group_size, codec):
    """Compressed two-shot AllReduce = ReduceScatter ∘ AllGather over the
    flattened tensor; identity codecs take the plain (uncompressed) sum."""
    if isinstance(codec, IdentityCodec):
        _check_group(group_size)
        return x
    flat, n = _pad_to(x.reshape(1, -1), group_size * codec.granule)
    rs = _rs_impl(flat[0], group_size, 0, codec)
    ag = _ag_impl(rs, group_size, 0, codec)
    return ag[:n].reshape(x.shape)


class _Collective(torch.autograd.Function):
    """One compressed collective with a straight-through backward:
    ``impl(x, *static)`` is the forward communication, ``bwd(ct, *static)``
    the conjugate collective on the cotangent (the JAX package's
    ``_compressed_collective``)."""

    @staticmethod
    def forward(ctx, x, impl, bwd, static):
        ctx.bwd, ctx.static = bwd, static
        return impl(x, *static)

    @staticmethod
    def backward(ctx, ct):
        return ctx.bwd(ct, *ctx.static), None, None, None


def _apply(x, impl, bwd, static):
    """``impl(x, *static)``, recorded for autograd when a gradient flows
    through ``x`` (the decode path runs without an autograd node)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, impl, bwd, static)
    return impl(x, *static)


def all_gather_c(x, group_size, dim, fwd_codec, bwd_codec):
    """Compressed all-gather concatenating along ``dim`` (tiled layout);
    backward is the compressed reduce-scatter with the codec pair
    swapped."""
    return _apply(
        x, lambda a, g, d, fc, bc: _ag_impl(a, g, d, fc),
        lambda ct, g, d, fc, bc: psum_scatter_c(ct, g, d, bc, fc),
        (group_size, dim, fwd_codec, bwd_codec))


def psum_scatter_c(x, group_size, dim, fwd_codec, bwd_codec):
    """Compressed reduce-scatter along ``dim`` (two-shot: every
    contribution compressed once, peers summed in index order); backward is
    the compressed all-gather with the codec pair swapped."""
    return _apply(
        x, lambda a, g, d, fc, bc: _rs_impl(a, g, d, fc),
        lambda ct, g, d, fc, bc: all_gather_c(ct, g, d, bc, fc),
        (group_size, dim, fwd_codec, bwd_codec))


def allreduce_g(x, group_size, fwd_codec, bwd_codec):
    """Megatron "g": forward compressed two-shot AllReduce (row-parallel
    outputs and the decode path); backward identity."""
    return _apply(
        x, lambda a, g, fc, bc: _ar_impl(a, g, fc),
        lambda ct, g, fc, bc: ct, (group_size, fwd_codec, bwd_codec))


def copy_f(x, group_size, fwd_codec, bwd_codec):
    """Megatron "f": forward identity (column-parallel inputs); backward
    compressed AllReduce with the BACKWARD codec."""
    return _apply(
        x, lambda a, g, fc, bc: a,
        lambda ct, g, fc, bc: _ar_impl(ct, g, bc),
        (group_size, fwd_codec, bwd_codec))


def psum_exact(x, group_size):
    """Sum over the group whose backward passes the (replicated) cotangent
    through unchanged — for scalars every consumer of which is replicated
    (losses, softmax statistics)."""
    return allreduce_g(x, group_size, Identity, Identity)
