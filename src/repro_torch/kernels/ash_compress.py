"""Fused ASH compress — CUDA ports of the TPU kernels
``repro/kernels/ash_compress.py`` ``compress_blocks_pallas`` (block form)
and ``compress_wire_pallas`` (wire form).

Two kernels (``csrc/ash_compress.cu``) read the input once: the block RMS
energy, the adaptive rescale, the Hadamard rotation (a butterfly in
registers and warp shuffles, in f64 at an f32 compute dtype), the
per-group max-abs scale and the saturating low-bit cast all happen in
registers.  ``compress_blocks`` writes the payload, alpha and scales as
three arrays; ``compress_wire`` writes each slot's packed uint8 wire row.
Both share one row body, so ``pack_wire`` of the block form is the wire
form byte for byte, and at an f32 compute dtype both give the plain
version's bits.  A lane holds E elements of a row, L = B/E lanes a row and
a warp 32/L rows, over a persistent grid: the launch geometry is
:func:`geometry`'s, passed to the C functions as it is.  The input may be
any contiguous view (unaligned ones take narrower loads) and a wire row may
start at any 4-byte offset.  The kernels are built for the block sizes of
:data:`BLOCK_SIZES`, at the elements a lane of :data:`KEPT_E` and
:data:`LATENCY_E`, and for an f32 or a bf16 compute dtype (rounding to
bf16 where the plain version does).

Each wrapper dispatches by the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref``), a CUDA tensor launches the kernel or
raises.  The TPU's tiling limits (``ROW_TILE``, the VMEM slot budget) do
not carry over: the kernels take any row count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

#: payload format codes of the C interface (csrc/ash_common.cuh)
FMT_CODE = {"e4m3": 0, "e5m2": 1, "int8": 2}
#: slots a wire call takes (the decompress wire forms put one slot per
#: grid row)
MAX_SLOTS = 65535
#: rows a call takes (decompress_blocks and decompress_reduce run 8 rows
#: per block on the grid's x axis; K2 divides row indices in 32 bits)
MAX_ROWS = 2**31 - 1
#: the block sizes B the CUDA kernels are built for (``with_shape`` in
#: csrc/ash_common.cuh): the paper's sweep
BLOCK_SIZES = (32, 64, 128, 256, 512)
#: elements a lane of K1 and K2 for each B: for many rows of bf16 input at
#: an f32 compute dtype, every training hop's (``kKeptE`` in
#: csrc/ash_compress.cu), and for rows that would not give every
#: multiprocessor a block at ``KEPT_E`` and every other input or compute
#: dtype (``kLatencyE``: the fewest elements a lane, so that a warp's serial
#: work is least; the library builds no other)
KEPT_E = {32: 16, 64: 32, 128: 32, 256: 32, 512: 32}
LATENCY_E = {32: 8, 64: 8, 128: 8, 256: 8, 512: 16}
#: threads a block, and blocks a streaming multiprocessor in the
#: persistent grid of K1 and K2
THREADS = 128
BLOCKS_PER_SM = 8


class Geometry(NamedTuple):
    """One launch of a persistent-grid compress kernel: ``e`` elements a
    lane, ``lanes`` a row, ``rows_per_warp`` (a row group),
    ``rows_per_block`` in one pass of the block's warps, ``groups`` row
    groups to cover, ``grid`` blocks of ``threads``.  Warp w of block k
    takes groups w + k W, w + k W + grid W, ... (W = threads / 32), group g
    rows [g R, g R + R)."""
    e: int
    lanes: int
    rows_per_warp: int
    rows_per_block: int
    groups: int
    grid: int
    threads: int


def launch_geometry(b: int, dtype: torch.dtype, rows: int, sms: int, e: int,
                    blocks_per_sm: int, threads: int) -> Geometry:
    """``rows`` rows of width ``b`` in ``dtype`` at ``e`` elements a lane
    (whole 16-byte words of input, 1 .. 32 lanes a row) on a card of
    ``sms`` multiprocessors, at most ``blocks_per_sm`` blocks of
    ``threads`` on each."""
    lanes = b // e
    if b % e or not 1 <= lanes <= 32:
        raise ValueError(f"no launch of B = {b} with {e} elements a lane")
    if e * torch.empty((), dtype=dtype).element_size() % 16:
        raise ValueError(f"{e} elements of {dtype} are not whole 16-byte "
                         f"words")
    rows_per_warp = 32 // lanes
    warps = threads // 32
    groups = -(-rows // rows_per_warp)
    grid = max(1, min(-(-groups // warps), sms * blocks_per_sm))
    return Geometry(e, lanes, rows_per_warp, rows_per_warp * warps, groups,
                    grid, threads)


def geometry(b: int, dtype: torch.dtype, rows: int, sms: int,
             e: int | None = None, blocks_per_sm: int | None = None,
             bf16_compute: bool = False) -> Geometry:
    """K1's and K2's launch for ``rows`` rows of width ``b`` in ``dtype``
    (at a bf16 compute dtype if ``bf16_compute``) on a card of ``sms``
    multiprocessors: ``KEPT_E[b]`` elements a lane for bf16 input at an
    f32 compute dtype where those rows give each multiprocessor a block of
    row groups, else ``LATENCY_E[b]``, and at most ``BLOCKS_PER_SM`` blocks
    a multiprocessor; ``e`` or ``blocks_per_sm`` say otherwise (the
    sweep's variants)."""
    if e is None:
        e = KEPT_E[b]
        if dtype != torch.bfloat16 or bf16_compute or \
                -(-rows // (32 * e // b)) < sms * (THREADS // 32):
            e = LATENCY_E[b]
    return launch_geometry(
        b, dtype, rows, sms, e,
        BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm, THREADS)


@functools.cache
def sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms_of(t: torch.Tensor) -> int:
    index = t.device.index
    return sms(torch.cuda.current_device() if index is None else index)


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
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.taco_compress_wire.argtypes = [p, p, i, i, i, ll, i, i, i, i, i, i,
                                       f, f, f, f, f, i, i, p]
    lib.taco_compress_wire.restype = i
    lib.taco_compress_blocks.argtypes = [p, p, p, p, i, ll, i, i, i, i, i,
                                         f, f, f, f, f, i, i, p]
    lib.taco_compress_blocks.restype = i
    return lib


@functools.cache
def _lib():
    return bind(build.library("ash_compress"))


def launch_blocks(lib, blocks: torch.Tensor, cfg, geo: Geometry):
    """K1 of ``lib`` on CUDA ``blocks`` (M, B) with ``geo``; returns (q,
    alpha, s) and counts nothing."""
    rows = blocks.shape[0]
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
        err = lib.taco_compress_blocks(
            blocks.data_ptr(), q.data_ptr(), alpha.data_ptr(), s.data_ptr(),
            int(blocks.dtype == torch.bfloat16), rows, b, geo.e, bf,
            FMT_CODE[cfg.fmt], g, cfg.tau, cfg.eps, cfg.scale_eps,
            cfg.format_spec.qmax, inv, geo.grid, geo.threads,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compress_blocks kernel launch failed: CUDA "
                           f"error {err}")
    return q, alpha, s


def launch_wire(lib, x: torch.Tensor, cfg, geo: Geometry) -> torch.Tensor:
    """K2 of ``lib`` on CUDA ``x`` (slots, n) with ``geo``; returns the wire
    rows and counts nothing."""
    slots, n = x.shape
    mb, g, _, _, total = wire_geometry(cfg, n)
    wire = torch.empty((slots, total), dtype=torch.uint8, device=x.device)
    if mb == 0 or slots == 0:
        return wire
    b, bf, inv = kernel_args(cfg)
    with torch.cuda.device(x.device):
        err = lib.taco_compress_wire(
            x.data_ptr(), wire.data_ptr(), int(x.dtype == torch.bfloat16),
            slots, n, total, b, geo.e, bf, FMT_CODE[cfg.fmt], g,
            int(cfg.metadata == "folded"), cfg.tau, cfg.eps, cfg.scale_eps,
            cfg.format_spec.qmax, inv, geo.grid, geo.threads,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"compress_wire kernel launch failed: CUDA error "
                           f"{err}")
    return wire


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
    geo = geometry(cfg.block_size, blocks.dtype, rows, _sms_of(blocks),
                   bf16_compute=kernel_args(cfg)[1] == 1)
    out = launch_blocks(_lib(), blocks, cfg, geo)
    if rows:
        compress_blocks.launches += 1
    return out


def compress_wire(x: torch.Tensor, cfg) -> torch.Tensor:
    """(slots, n) bf16/f32 -> (slots, total_bytes) packed uint8 wire rows,
    byte-compatible with ``pack_wire(TacoCodec.encode(x))``; n a multiple
    of the block size."""
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
    if n % cfg.block_size:
        raise ValueError(f"compress_wire: n = {n} is not a multiple of the "
                         f"block size {cfg.block_size}")
    rows = slots * (n // cfg.block_size)
    if rows > MAX_ROWS:
        raise ValueError(f"compress_wire: {rows} rows > {MAX_ROWS}")
    geo = geometry(cfg.block_size, x.dtype, rows, _sms_of(x),
                   bf16_compute=kernel_args(cfg)[1] == 1)
    wire = launch_wire(_lib(), x, cfg, geo)
    if rows:
        compress_wire.launches += 1
    return wire


compress_blocks.launches = 0
compress_wire.launches = 0
