"""Fused ASH decompress out of packed wire rows — CUDA ports of the TPU
kernels ``repro/kernels/ash_decompress.py`` ``decompress_wire_pallas``
(all-gather receiver) and ``decompress_reduce_wire_pallas``
(reduce-scatter receiver).

Both kernels (``csrc/ash_decompress.cu``) read the payload, scales and
alpha at their static ``wire_layout(n)`` byte offsets, dequantize and
rotate back with a shared-memory butterfly; the reduce kernel sums the
peers in the rotated domain first, so P peers cost ONE rotation.  They
write the compute dtype (f32); the codec casts to the hop's dtype.

Each wrapper dispatches by the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref``), a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ash_compress import (FMT_CODE, MAX_SLOTS,
                                              check_supported, wire_geometry)


@functools.cache
def _lib():
    lib = build.library("ash_decompress")
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.taco_decompress_wire.argtypes = [p, p, i, i, ll, i, i, i, p]
    lib.taco_decompress_wire.restype = i
    lib.taco_decompress_reduce_wire.argtypes = [p, p, i, i, ll, i, i, i, p]
    lib.taco_decompress_reduce_wire.restype = i
    return lib


def _check_wire(name, wire, n, cfg):
    """Validate a CUDA wire stack against the layout for ``n``; returns
    ``(mb, groups, total)``."""
    check_supported(cfg)
    if wire.dim() != 2 or wire.dtype != torch.uint8:
        raise ValueError(f"{name} takes (rows, total) uint8, got "
                         f"{tuple(wire.shape)} {wire.dtype}")
    if not wire.is_contiguous():
        raise ValueError(f"{name} needs a contiguous wire buffer")
    if wire.shape[0] > MAX_SLOTS:
        raise ValueError(f"{name}: {wire.shape[0]} rows > {MAX_SLOTS}")
    mb, groups, _, _, total = wire_geometry(cfg, n)
    if wire.shape[1] != total:
        raise ValueError(f"wire row has {wire.shape[1]} bytes, layout for "
                         f"n={n} declares {total}")
    return mb, groups, total


def _device_check(name, wire):
    if wire.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {wire.device}")


def decompress_wire(wire: torch.Tensor, n: int, cfg) -> torch.Tensor:
    """(slots, total_bytes) packed uint8 -> (slots, n) f32."""
    if wire.device.type == "cpu":
        return ref.decompress_wire_ref(wire, n, cfg)
    _device_check("decompress_wire", wire)
    mb, groups, total = _check_wire("decompress_wire", wire, n, cfg)
    slots = wire.shape[0]
    out = torch.empty((slots, n), dtype=torch.float32, device=wire.device)
    if mb == 0 or slots == 0:
        return out
    with torch.cuda.device(wire.device):
        err = _lib().taco_decompress_wire(
            wire.data_ptr(), out.data_ptr(), slots, n, total,
            FMT_CODE[cfg.fmt], groups, int(cfg.metadata == "folded"),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decompress_wire kernel launch failed: CUDA "
                           f"error {err}")
    decompress_wire.launches += 1
    return out


def decompress_reduce_wire(wire: torch.Tensor, n: int, cfg) -> torch.Tensor:
    """Peer-stacked packed rows (P, total_bytes) -> peer sum (n/B, B) f32."""
    if wire.device.type == "cpu":
        return ref.decompress_reduce_wire_ref(wire, n, cfg)
    _device_check("decompress_reduce_wire", wire)
    mb, groups, total = _check_wire("decompress_reduce_wire", wire, n, cfg)
    peers = wire.shape[0]
    if peers == 0:
        raise ValueError("decompress_reduce_wire needs at least one peer row")
    out = torch.empty((mb, cfg.block_size), dtype=torch.float32,
                      device=wire.device)
    if mb == 0:
        return out
    with torch.cuda.device(wire.device):
        err = _lib().taco_decompress_reduce_wire(
            wire.data_ptr(), out.data_ptr(), peers, n, total,
            FMT_CODE[cfg.fmt], groups, int(cfg.metadata == "folded"),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decompress_reduce_wire kernel launch failed: "
                           f"CUDA error {err}")
    decompress_reduce_wire.launches += 1
    return out


decompress_wire.launches = 0
decompress_reduce_wire.launches = 0
