"""ASH compress with a warp-level butterfly rotation — the CUDA port (K7) of
the TPU kernel ``repro/kernels/fwht_butterfly.py``
``compress_blocks_butterfly``.

K1's math with block-level scales only: per row of B elements, the RMS
rescale alpha = tau / sigma, the O(B log B) Walsh-Hadamard butterfly scaled
by 1/sqrt(B), ONE scale s = max(max|z| / qmax, 1e-30) and the saturating
low-bit cast.  The floor is the reference's fixed 1e-30, not
``cfg.scale_eps`` (their defaults agree).  The kernel
(``csrc/fwht_butterfly.cu``) takes one warp per row and keeps the row in
registers: B/32 elements per lane, the first butterfly stages inside a
lane, the last five across lanes by warp shuffles, no shared memory.  It
lies on no path of either package (the JAX package keeps it as the
measured counterpoint to its matmul rotation); ``chip_smoke.py`` measures
it beside K1.

The wrapper dispatches by the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref.compress_blocks_butterfly_ref``), a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ash_compress import FMT_CODE

#: the row widths the kernel takes (B/32 elements per lane: 1, 2, 4, 8,
#: 16), every power of two the JAX kernel's sweep takes
BLOCK_SIZES = (32, 64, 128, 256, 512)


@functools.cache
def _lib():
    lib = build.library("fwht_butterfly")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.taco_compress_blocks_butterfly.argtypes = [
        p, p, p, p, i, i, ctypes.c_longlong, i, f, f, f, f, p]
    lib.taco_compress_blocks_butterfly.restype = i
    return lib


def compress_blocks_butterfly(blocks: torch.Tensor, cfg):
    """(M, B) bf16/f32 block rows -> (q (M, B) storage dtype, alpha (M,)
    f32, s (M, 1) f32), the arrays of ``ref.compress_blocks_butterfly_ref``;
    B is ``blocks.shape[1]`` (32 .. 512 on the card)."""
    if blocks.device.type == "cpu":
        return ref.compress_blocks_butterfly_ref(blocks, cfg)
    if blocks.device.type != "cuda":
        raise ValueError(f"compress_blocks_butterfly: no kernel for device "
                         f"{blocks.device}")
    if blocks.dim() != 2 or blocks.shape[1] not in BLOCK_SIZES or \
            blocks.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compress_blocks_butterfly takes (M, B) bf16/f32 "
                         f"with B in {BLOCK_SIZES}, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if not blocks.is_contiguous() or blocks.data_ptr() % 16:
        raise ValueError("compress_blocks_butterfly needs a contiguous, "
                         "16-byte aligned input")
    rows, b = blocks.shape
    fmt = cfg.format_spec
    dev = blocks.device
    q = torch.empty((rows, b), dtype=fmt.dtype, device=dev)
    alpha = torch.empty((rows,), dtype=torch.float32, device=dev)
    s = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    if rows == 0:
        return q, alpha, s
    with torch.cuda.device(dev):
        err = _lib().taco_compress_blocks_butterfly(
            blocks.data_ptr(), q.data_ptr(), alpha.data_ptr(), s.data_ptr(),
            int(blocks.dtype == torch.bfloat16), b, rows, FMT_CODE[cfg.fmt],
            cfg.tau, cfg.eps, fmt.qmax, float(np.float32(1.0 / b ** 0.5)),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compress_blocks_butterfly kernel launch failed: "
                           f"CUDA error {err}")
    compress_blocks_butterfly.launches += 1
    return q, alpha, s


compress_blocks_butterfly.launches = 0


def flops_per_element(b: int) -> dict:
    """Structural cost of the two rotation forms per tensor element: the
    dense matmul against the B x B Hadamard matrix (K1's form) and the
    log2(B)-stage butterfly (this kernel's); the JAX package's counts."""
    return {"mxu_matmul": 2 * b, "vpu_butterfly": 2 * math.log2(b)}
