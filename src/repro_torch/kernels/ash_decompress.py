"""Fused ASH decompress — CUDA ports of the TPU kernels
``repro/kernels/ash_decompress.py`` ``decompress_blocks_pallas`` and
``decompress_wire_pallas`` (all-gather receiver, block and wire form),
``decompress_reduce_pallas`` and ``decompress_reduce_wire_pallas``
(reduce-scatter receiver, block and wire form).

The kernels (``csrc/ash_decompress.cu``) dequantize and rotate back, one
warp per block row, rotating in registers and warp shuffles (the
butterfly of the compress kernels); the reduce kernels sum the peers in
the rotated domain first, so P peers cost ONE rotation.  The block forms
read the payload, scales and alpha as separate arrays, the wire forms at
their static ``wire_layout(n)`` byte offsets; each pair shares one
per-row body, so a block form on ``unpack_wire(w)`` equals its wire form
on ``w`` bit for bit.  The wire forms take a wire view at any byte
address.  They compute in f32 (rounding to bf16 where the plain version
does under a bf16 compute dtype) and return the compute dtype; the codec
casts to the hop's dtype.

Each wrapper dispatches by the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref``), a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ash_compress, build, ref
from repro_torch.kernels.ash_compress import (FMT_CODE, MAX_ROWS,
                                              MAX_SLOTS, check_supported,
                                              kernel_args, wire_geometry)


@functools.cache
def _lib():
    lib = build.library("ash_decompress")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.taco_decompress_wire.argtypes = [p, p, i, i, ll, i, i, i, i, i, f, p]
    lib.taco_decompress_wire.restype = i
    lib.taco_decompress_reduce_wire.argtypes = [p, p, i, i, ll, i, i, i, i,
                                                i, f, p]
    lib.taco_decompress_reduce_wire.restype = i
    lib.taco_decompress_blocks.argtypes = [p, p, p, p, ll, i, i, i, i, f, p]
    lib.taco_decompress_blocks.restype = i
    lib.taco_decompress_reduce.argtypes = [p, p, p, p, i, ll, i, i, i, i, f,
                                           p]
    lib.taco_decompress_reduce.restype = i
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


def _device_check(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _check_blocks(name, q, s, alpha, cfg):
    """Validate CUDA block arrays: q (..., M, B) one-byte payload, s
    (..., M, G) f32, alpha (..., M) f32 or None, all contiguous; returns
    ``(rows, groups)``."""
    check_supported(cfg)
    lead = q.shape[:-1]
    if q.element_size() != 1 or q.shape[-1] != cfg.block_size:
        raise ValueError(f"{name}: q must be (..., {cfg.block_size}) "
                         f"one-byte codes, got {tuple(q.shape)} {q.dtype}")
    groups = ash_compress.groups(cfg)
    if s.dtype != torch.float32 or tuple(s.shape) != (*lead, groups):
        raise ValueError(f"{name}: s must be {(*lead, groups)} f32, got "
                         f"{tuple(s.shape)} {s.dtype}")
    if alpha is not None and (alpha.dtype != torch.float32
                              or tuple(alpha.shape) != tuple(lead)):
        raise ValueError(f"{name}: alpha must be {tuple(lead)} f32, got "
                         f"{tuple(alpha.shape)} {alpha.dtype}")
    for t in (q, s) if alpha is None else (q, s, alpha):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs on one device")
    rows = lead[-1]
    if rows > MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows > {MAX_ROWS}")
    return rows, groups


def _ptr(t):
    return None if t is None else t.data_ptr()


def decompress_blocks(q: torch.Tensor, s: torch.Tensor, alpha,
                      cfg) -> torch.Tensor:
    """(q (M, B), s (M, G), alpha (M,) | None) -> blocks (M, B) in the
    compute dtype.  alpha=None means folded metadata."""
    if q.device.type == "cpu":
        return ref.decompress_blocks_ref(q, s, alpha, cfg).to(
            cfg.torch_compute_dtype)
    _device_check("decompress_blocks", q)
    if q.dim() != 2:
        raise ValueError(f"decompress_blocks takes q (M, B), got "
                         f"{tuple(q.shape)}")
    rows, groups = _check_blocks("decompress_blocks", q, s, alpha, cfg)
    out = torch.empty((rows, cfg.block_size), dtype=torch.float32,
                      device=q.device)
    if rows == 0:
        return out.to(cfg.torch_compute_dtype)
    b, bf, inv = kernel_args(cfg)
    with torch.cuda.device(q.device):
        err = _lib().taco_decompress_blocks(
            q.data_ptr(), s.data_ptr(), _ptr(alpha), out.data_ptr(), rows, b,
            bf, FMT_CODE[cfg.fmt], groups, inv,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decompress_blocks kernel launch failed: CUDA "
                           f"error {err}")
    decompress_blocks.launches += 1
    return out.to(cfg.torch_compute_dtype)


def decompress_reduce(q: torch.Tensor, s: torch.Tensor, alpha,
                      cfg) -> torch.Tensor:
    """Stacked peers q (P, M, B), s (P, M, G), alpha (P, M) | None ->
    peer sum (M, B) in the compute dtype, summed in peer-index order in the rotated domain
    with ONE inverse rotation."""
    if q.device.type == "cpu":
        return ref.decompress_reduce_ref(q, s, alpha, cfg).to(
            cfg.torch_compute_dtype)
    _device_check("decompress_reduce", q)
    if q.dim() != 3 or q.shape[0] == 0:
        raise ValueError(f"decompress_reduce takes q (P, M, B) with P >= 1, "
                         f"got {tuple(q.shape)}")
    rows, groups = _check_blocks("decompress_reduce", q, s, alpha, cfg)
    peers = q.shape[0]
    out = torch.empty((rows, cfg.block_size), dtype=torch.float32,
                      device=q.device)
    if rows == 0:
        return out.to(cfg.torch_compute_dtype)
    b, bf, inv = kernel_args(cfg)
    with torch.cuda.device(q.device):
        err = _lib().taco_decompress_reduce(
            q.data_ptr(), s.data_ptr(), _ptr(alpha), out.data_ptr(), peers,
            rows, b, bf, FMT_CODE[cfg.fmt], groups, inv,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decompress_reduce kernel launch failed: CUDA "
                           f"error {err}")
    decompress_reduce.launches += 1
    return out.to(cfg.torch_compute_dtype)


def decompress_wire(wire: torch.Tensor, n: int, cfg) -> torch.Tensor:
    """(slots, total_bytes) packed uint8 -> (slots, n) in the compute
    dtype."""
    if wire.device.type == "cpu":
        return ref.decompress_wire_ref(wire, n, cfg)
    _device_check("decompress_wire", wire)
    mb, groups, total = _check_wire("decompress_wire", wire, n, cfg)
    slots = wire.shape[0]
    out = torch.empty((slots, n), dtype=torch.float32, device=wire.device)
    if mb == 0 or slots == 0:
        return out.to(cfg.torch_compute_dtype)
    b, bf, inv = kernel_args(cfg)
    with torch.cuda.device(wire.device):
        err = _lib().taco_decompress_wire(
            wire.data_ptr(), out.data_ptr(), slots, n, total, b, bf,
            FMT_CODE[cfg.fmt], groups, int(cfg.metadata == "folded"), inv,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decompress_wire kernel launch failed: CUDA "
                           f"error {err}")
    decompress_wire.launches += 1
    return out.to(cfg.torch_compute_dtype)


def decompress_reduce_wire(wire: torch.Tensor, n: int, cfg) -> torch.Tensor:
    """Peer-stacked packed rows (P, total_bytes) -> peer sum (n/B, B) in
    the compute dtype."""
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
        return out.to(cfg.torch_compute_dtype)
    b, bf, inv = kernel_args(cfg)
    with torch.cuda.device(wire.device):
        err = _lib().taco_decompress_reduce_wire(
            wire.data_ptr(), out.data_ptr(), peers, n, total, b, bf,
            FMT_CODE[cfg.fmt], groups, int(cfg.metadata == "folded"), inv,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decompress_reduce_wire kernel launch failed: "
                           f"CUDA error {err}")
    decompress_reduce_wire.launches += 1
    return out.to(cfg.torch_compute_dtype)


decompress_blocks.launches = 0
decompress_reduce.launches = 0
decompress_wire.launches = 0
decompress_reduce_wire.launches = 0
