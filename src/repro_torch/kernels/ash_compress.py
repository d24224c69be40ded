"""Fused ASH compress — CUDA ports of the TPU kernels
``repro/kernels/ash_compress.py`` ``compress_blocks_pallas`` (block form)
and ``compress_wire_pallas`` (wire form).

Two kernels (``csrc/ash_compress.cu``) read the input once, one warp per
block row: the block RMS energy, the adaptive rescale, the Hadamard
rotation (a butterfly in registers and warp shuffles), the per-group
max-abs scale and the saturating low-bit cast all happen in registers.
``compress_blocks`` writes the payload, alpha and scales as three arrays;
``compress_wire`` writes each slot's packed uint8 wire row.  Both share one
per-row body, so ``pack_wire`` of the block form is the wire form byte for
byte.  The input may be any contiguous view (unaligned ones take narrower
loads) and a wire row may start at any 4-byte offset.  The kernels are
built for the block sizes of :data:`BLOCK_SIZES` and for an f32 or a bf16
compute dtype (rounding to bf16 where the plain version does).

Each wrapper dispatches by the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref``), a CUDA tensor launches the kernel or
raises.  The TPU's tiling limits (``ROW_TILE``, the VMEM slot budget) do
not carry over: the kernels take any row count.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, ref

#: payload format codes of the C interface (csrc/ash_common.cuh)
FMT_CODE = {"e4m3": 0, "e5m2": 1, "int8": 2}
#: grid.y limit: the wire forms put one slot per grid row
MAX_SLOTS = 65535
#: grid.x limit: compress_blocks, decompress_blocks and decompress_reduce
#: each run 8 rows per block (one warp each) on the x axis
MAX_ROWS = 2**31 - 1
#: the block sizes B the CUDA kernels are built for (``with_shape`` in
#: csrc/ash_common.cuh): the paper's sweep
BLOCK_SIZES = (32, 64, 128, 256, 512)


def supported(cfg) -> bool:
    """The configurations the CUDA kernels are for, as the TPU kernels'
    ``supported``: the ash transform with block-or-finer scales.  The
    others (another transform, tensor scales) have only a plain
    version."""
    return cfg.transform == "ash" and cfg.scale_granularity == "block"


def check_supported(cfg) -> None:
    if not supported(cfg) or cfg.block_size not in BLOCK_SIZES:
        raise NotImplementedError(
            f"the CUDA wire kernels cover transform='ash' and block scales "
            f"at block_size in {BLOCK_SIZES}; got {cfg}")


def kernel_args(cfg) -> tuple[int, int, float]:
    """``(block, bf16_compute, inv_sqrt_b)`` of the C interface: the block
    size, whether the compute dtype is bf16, and the plain version's
    1/sqrt(B) in that dtype (the entry of ``ash.hadamard_matrix``)."""
    cd = cfg.torch_compute_dtype
    b = cfg.block_size
    inv = float(torch.tensor(1.0 / np.sqrt(b), dtype=cd))
    return b, int(cd == torch.bfloat16), inv


def groups(cfg) -> int:
    """Quantization groups per block row; the group size must divide the
    block size (as in the plain version)."""
    b = cfg.block_size
    gs = cfg.quant_group_size or b
    if b % gs:
        raise ValueError(f"group_size {gs} must divide block {b}")
    return b // gs


def wire_geometry(cfg, n: int):
    """Static byte geometry of one ``n``-element wire slot: ``(mb, groups,
    scale_nbytes, alpha_nbytes, total_bytes)``, derived from
    ``taco.wire_components`` — the layout the transport packs."""
    from repro_torch.core import taco as taco_mod

    comps = {name: (dtype, size)
             for name, dtype, size in taco_mod.wire_components(cfg, n)}
    mb = n // cfg.block_size
    scale_nbytes = comps["scale"][1] * np.dtype(comps["scale"][0]).itemsize
    alpha_nbytes = 0
    if "alpha" in comps:
        alpha_nbytes = comps["alpha"][1] * np.dtype(comps["alpha"][0]).itemsize
    return mb, groups(cfg), scale_nbytes, alpha_nbytes, \
        n + scale_nbytes + alpha_nbytes


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C functions' arguments on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.taco_compress_wire.argtypes = [p, p, i, i, i, ctypes.c_longlong, i,
                                       i, i, i, i, f, f, f, f, f, p]
    lib.taco_compress_wire.restype = i
    lib.taco_compress_blocks.argtypes = [p, p, p, p, i, ctypes.c_longlong,
                                         i, i, i, i, f, f, f, f, f, p]
    lib.taco_compress_blocks.restype = i
    return lib


@functools.cache
def _lib():
    return bind(build.library("ash_compress"))


def compress_blocks(blocks: torch.Tensor, cfg):
    """(M, B) bf16/f32 block rows -> (q (M, B) storage dtype, alpha (M,)
    f32, s (M, G) f32), the arrays of ``ref.compress_blocks_ref``."""
    if blocks.device.type == "cpu":
        return ref.compress_blocks_ref(blocks, cfg)
    if blocks.device.type != "cuda":
        raise ValueError(f"compress_blocks: no kernel for device "
                         f"{blocks.device}")
    check_supported(cfg)
    if blocks.dim() != 2 or blocks.shape[1] != cfg.block_size or \
            blocks.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compress_blocks takes (M, {cfg.block_size}) "
                         f"bf16/f32, got {tuple(blocks.shape)} "
                         f"{blocks.dtype}")
    if not blocks.is_contiguous():
        raise ValueError("compress_blocks needs a contiguous input")
    rows = blocks.shape[0]
    if rows > MAX_ROWS:
        raise ValueError(f"compress_blocks: {rows} rows > {MAX_ROWS}")
    g = groups(cfg)
    dev = blocks.device
    q = torch.empty((rows, cfg.block_size), dtype=cfg.format_spec.dtype,
                    device=dev)
    alpha = torch.empty((rows,), dtype=torch.float32, device=dev)
    s = torch.empty((rows, g), dtype=torch.float32, device=dev)
    if rows == 0:
        return q, alpha, s
    b, bf, inv = kernel_args(cfg)
    with torch.cuda.device(dev):
        err = _lib().taco_compress_blocks(
            blocks.data_ptr(), q.data_ptr(), alpha.data_ptr(), s.data_ptr(),
            int(blocks.dtype == torch.bfloat16), rows, b, bf,
            FMT_CODE[cfg.fmt], g, cfg.tau, cfg.eps, cfg.scale_eps,
            cfg.format_spec.qmax, inv,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compress_blocks kernel launch failed: CUDA "
                           f"error {err}")
    compress_blocks.launches += 1
    return q, alpha, s


def compress_wire(x: torch.Tensor, cfg) -> torch.Tensor:
    """(slots, n) bf16/f32 -> (slots, total_bytes) packed uint8 wire rows,
    byte-compatible with ``pack_wire(TacoCodec.encode(x))``."""
    if x.device.type == "cpu":
        return ref.compress_wire_ref(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"compress_wire: no kernel for device {x.device}")
    check_supported(cfg)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compress_wire takes (slots, n) bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("compress_wire needs a contiguous input")
    slots, n = x.shape
    if slots > MAX_SLOTS:
        raise ValueError(f"compress_wire: {slots} slots > {MAX_SLOTS}")
    mb, g, _, _, total = wire_geometry(cfg, n)
    wire = torch.empty((slots, total), dtype=torch.uint8, device=x.device)
    if mb == 0 or slots == 0:
        return wire
    b, bf, inv = kernel_args(cfg)
    with torch.cuda.device(x.device):
        err = _lib().taco_compress_wire(
            x.data_ptr(), wire.data_ptr(), int(x.dtype == torch.bfloat16),
            slots, n, total, b, bf, FMT_CODE[cfg.fmt], g,
            int(cfg.metadata == "folded"), cfg.tau, cfg.eps, cfg.scale_eps,
            cfg.format_spec.qmax, inv,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compress_wire kernel launch failed: CUDA error "
                           f"{err}")
    compress_wire.launches += 1
    return wire


compress_blocks.launches = 0
compress_wire.launches = 0
