"""ASH compress with a butterfly rotation — the CUDA port (K7) of the TPU
kernel ``repro/kernels/fwht_butterfly.py`` ``compress_blocks_butterfly``
(``pallas_call`` at line 65).

K1's math with block-level scales only: per row of B elements, the RMS
rescale alpha = tau / sigma, the O(B log B) Walsh-Hadamard butterfly scaled
by 1/sqrt(B), ONE scale s = max(max|z| / qmax, 1e-30) and the saturating
low-bit cast.  The floor is the reference's fixed 1e-30, not
``cfg.scale_eps`` (their defaults agree).  It lies on no path of either
package (the JAX package keeps it as the measured counterpoint to its
matmul rotation); ``chip_smoke.py`` phase 1c measures it at every B.

On the H100 it is bound by bytes (2 or 4 read and 1 written an element)
and as much by the issue rate (30-40 instructions an element).  The kernel
(``csrc/fwht_butterfly.cu``) keeps a row in registers with E elements a
lane, read as whole 16-byte words, so L = B/E lanes hold a row and a warp
takes 32/L rows: the cross-lane butterfly stages and both reductions
shuffle inside a row's L lanes, and one warp-wide shuffle serves 32/L rows
(none at B = 32, where E = 32 puts a row in one lane).  The grid is
persistent, and each warp loads its next row group before it computes the
current one.  Every product and sum is rounded once in the plain
version's order, so the kernel gives its bits.  The launch geometry (E,
lanes, rows a warp and a block, the grid) is :func:`geometry`'s, passed
to the C function as it is.

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
from repro_torch.kernels.ash_compress import (FMT_CODE, Geometry,
                                              launch_geometry)
from repro_torch.kernels.ash_compress import sms as _sms

#: the row widths the kernel takes, every power of two the JAX kernel's
#: sweep takes
BLOCK_SIZES = (32, 64, 128, 256, 512)
#: elements a lane for each B, bf16 and f32 input alike (``kKeptE`` in
#: csrc/fwht_butterfly.cu): the fastest of the sweep of E = 8, 16, 32 and
#: 1, 2, 4, 8 or 16 blocks a multiprocessor or one pass, at every B, bf16
#: in, on an H100 (``scripts/k7_sweep.py``, PERF.md): E = 32 at 4 blocks
#: a multiprocessor (80 registers: 3 resident)
KEPT_E = {32: 32, 64: 32, 128: 32, 256: 32, 512: 32}
#: threads a block, and blocks a streaming multiprocessor in the
#: persistent grid
THREADS = 256
BLOCKS_PER_SM = 4


def geometry(b: int, dtype: torch.dtype, rows: int, sms: int,
             e: int | None = None,
             blocks_per_sm: int | None = None) -> Geometry:
    """The launch geometry (``ash_compress.launch_geometry``) for ``rows``
    rows of width ``b`` in ``dtype`` on a card of ``sms``
    multiprocessors: ``KEPT_E[b]`` elements a lane and at most
    ``BLOCKS_PER_SM`` blocks a multiprocessor unless ``e`` or
    ``blocks_per_sm`` say otherwise (the sweep's variants)."""
    return launch_geometry(
        b, dtype, rows, sms, KEPT_E[b] if e is None else e,
        BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm, THREADS)


@functools.cache
def _lib():
    return bind(build.library("fwht_butterfly"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C function's arguments on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.taco_compress_blocks_butterfly.argtypes = [
        p, p, p, p, i, i, i, ctypes.c_longlong, i, f, f, f, f, i, i, p]
    lib.taco_compress_blocks_butterfly.restype = i
    return lib


def launch(lib, blocks: torch.Tensor, cfg, geo: Geometry):
    """Run the kernel of ``lib`` on CUDA ``blocks`` with ``geo``; returns
    (q, alpha, s) and counts nothing."""
    rows, b = blocks.shape
    fmt = cfg.format_spec
    dev = blocks.device
    q = torch.empty((rows, b), dtype=fmt.dtype, device=dev)
    alpha = torch.empty((rows,), dtype=torch.float32, device=dev)
    s = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    if rows == 0:
        return q, alpha, s
    with torch.cuda.device(dev):
        err = lib.taco_compress_blocks_butterfly(
            blocks.data_ptr(), q.data_ptr(), alpha.data_ptr(), s.data_ptr(),
            int(blocks.dtype == torch.bfloat16), b, geo.e, rows,
            FMT_CODE[cfg.fmt], cfg.tau, cfg.eps, fmt.qmax,
            float(np.float32(1.0 / b ** 0.5)), geo.grid, geo.threads,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compress_blocks_butterfly kernel launch failed: "
                           f"CUDA error {err}")
    return q, alpha, s


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
    index = blocks.device.index
    geo = geometry(b, blocks.dtype, rows,
                   _sms(torch.cuda.current_device() if index is None
                        else index))
    out = launch(_lib(), blocks, cfg, geo)
    if rows:
        compress_blocks_butterfly.launches += 1
    return out


compress_blocks_butterfly.launches = 0


def flops_per_element(b: int) -> dict:
    """Structural cost of the two rotation forms per tensor element: the
    dense matmul against the B x B Hadamard matrix (K1's form) and the
    log2(B)-stage butterfly (this kernel's); the JAX package's counts."""
    return {"mxu_matmul": 2 * b, "vpu_butterfly": 2 * math.log2(b)}
