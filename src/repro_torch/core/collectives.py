"""Compressed collectives — the paper's §4.4.2 communication layer.

Compression follows COCCL's two-shot decomposition, as the JAX package:

  ReduceScatter = one compressed all-to-all + ONE fused local reduction
  AllGather     = one compressed all-gather + fused decompress
  AllReduce     = ReduceScatter ∘ AllGather  (two compressions per round)

``_transport`` pads to the codec granule, encodes straight into ONE
packed uint8 wire buffer (``encode_wire``), moves it, and decodes straight
from the moved buffer (``decode_wire``, or ``decode_sum_wire`` when the
hop reduces).  On a TACO plan each AllReduce therefore launches the fused
compress kernel twice, the decompress-reduce kernel once and the
decompress kernel once.

The move takes the group size.  At size 1 it is the identity on the wire
— as JAX's size-1 ``all_to_all`` / ``all_gather`` is — and encode and
decode still run.  Larger groups (the NCCL transport) and the chunked
ring (``chunks > 1``, ``core/overlap.py``) are the next slice and raise.
This slice runs the serving forward only: ``allreduce_g`` / ``copy_f``
have no backward here.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import IdentityCodec


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


def _ar_impl(x, group_size, codec):
    """Compressed two-shot AllReduce = ReduceScatter ∘ AllGather over the
    flattened tensor; identity codecs take the plain (uncompressed) sum."""
    if isinstance(codec, IdentityCodec):
        _check_group(group_size)
        return x
    flat, n = _pad_to(x.reshape(1, -1), group_size * codec.granule)
    rs = _rs_one(flat[0], group_size, 0, codec)
    ag = _ag_one(rs, group_size, 0, codec)
    return ag[:n].reshape(x.shape)


def allreduce_g(x, group_size, fwd_codec, bwd_codec):
    """Megatron "g": forward compressed two-shot AllReduce (row-parallel
    outputs and the decode path); backward identity."""
    return _ar_impl(x, group_size, fwd_codec)


def copy_f(x, group_size, fwd_codec, bwd_codec):
    """Megatron "f": forward identity (column-parallel inputs); its
    backward AllReduce with ``bwd_codec`` comes with the training slice."""
    return x
