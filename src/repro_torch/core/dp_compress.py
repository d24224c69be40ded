"""SDP4bit-style 4-bit gradient compression for the DP / fsdp path (paper
§4, "integrate TACO with SDP4Bit") — the JAX package's
``repro/core/dp_compress.py`` in PyTorch.

Hadamard pre-rotation (outlier smearing) + per-block symmetric int4 with a
per-block f32 scale, nibble-packed two values per byte.  Wire cost: 0.5
B/elem payload + 4/block B/elem metadata (block 128: ~0.53 B/elem).

The rotation is ``z @ H_block`` in f32 through ``ash._rotate`` (f64
accumulation, one rounding, TF32 off on the card), so a row's result does
not depend on how many rows the call holds: a chunked ring hop and the
monolithic hop encode and decode each block bit for bit alike.  Rounding
is half to even (``torch.round``, as ``jnp.round``).

``decompress_sum_int4`` sums the peers in the rotated domain, in peer
order, and applies one inverse rotation (the linearity trick of the TACO
reduce).  These are plain PyTorch on either device: the JAX package
computes them in ``jnp``, outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ash as ash_mod

INT4_MAX = 7.0


def int4_pack(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], even trailing dim -> uint8 nibble pairs."""
    biased = (q + 8).to(torch.uint8)
    return biased[..., 0::2] | (biased[..., 1::2] << 4)


def int4_unpack(p: torch.Tensor) -> torch.Tensor:
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def _rotate(z: torch.Tensor, block: int) -> torch.Tensor:
    return ash_mod._rotate(z, ash_mod.hadamard_matrix(block, torch.float32,
                                                      z.device))


def compress_int4(x: torch.Tensor, block: int, rotate: bool):
    """x (..., n) with n % block == 0 -> (packed uint8 (..., n/2),
    s f32 (..., n/block))."""
    lead, n = x.shape[:-1], x.shape[-1]
    z = x.float().reshape(*lead, n // block, block)
    if rotate:
        z = _rotate(z, block)
    s = torch.clamp_min(z.abs().amax(dim=-1) / INT4_MAX, 1e-30)
    q = torch.clamp(torch.round(z / s[..., None]), -INT4_MAX,
                    INT4_MAX).to(torch.int8)
    return int4_pack(q).reshape(*lead, n // 2), s.reshape(*lead, n // block)


def decompress_int4(packed, s, n: int, block: int, rotate: bool, dtype):
    """Inverse of :func:`compress_int4` -> (..., n) in ``dtype``."""
    lead = packed.shape[:-1]
    q = int4_unpack(packed).reshape(*lead, n // block, block).float()
    z = q * s.reshape(*lead, n // block, 1)
    if rotate:
        z = _rotate(z, block)
    return z.reshape(*lead, n).to(dtype)


def decompress_sum_int4(packed, s, n: int, block: int, rotate: bool, dtype):
    """packed (P, ..., n/2) -> the sum over P in peer order, one inverse
    rotation in all."""
    p, lead = packed.shape[0], packed.shape[1:-1]
    q = int4_unpack(packed).reshape(p, *lead, n // block, block).float()
    terms = q * s.reshape(p, *lead, n // block, 1)
    z = terms[0]
    for j in range(1, p):
        z = z + terms[j]
    if rotate:
        z = _rotate(z, block)
    return z.reshape(*lead, n).to(dtype)


# --------------------------------------------------------------------------
# the parity rule between two implementations of the codec (the CPU and the
# card, or this package and the JAX package): their rotations sum in other
# orders, so a value at a rounding boundary may land one code apart
# --------------------------------------------------------------------------

#: at most this fraction of the int4 codes may differ, each by one (so a
#: comparison of fewer than 1e4 codes must match exactly), not counting
#: the codes at a tie (below)
CODE_FLIP_FRACTION = 1e-4
#: scales within this relative error
SCALE_RTOL = 1e-5
#: a code whose exact ``z / s`` (f64, from the same input) lies this close
#: to a half-integer sits at a tie, which the last bit of the rotation
#: decides: such ties are structural where a stage re-encodes a decoded
#: block cut at a chunk boundary (the rotation of a dyadic slice of a
#: rotated block averages its codes over cosets, ``k + 0.5`` exactly)
TIE_ATOL = 1e-5


def _fields(wire: torch.Tensor, n: int, block: int):
    """Packed wire rows (..., n/2 + 4n/block) -> (codes (..., n/block,
    block) int8, scales (..., n/block) f32)."""
    wire = wire.cpu().contiguous()
    codes = int4_unpack(wire[..., :n // 2])
    s = wire[..., n // 2:].contiguous().view(torch.float32)
    return codes.reshape(*wire.shape[:-1], n // block, block), s


def check_wire_parity(got: torch.Tensor, want: torch.Tensor, n: int,
                      block: int, *, x: torch.Tensor | None = None,
                      rotate: bool = True,
                      flip_fraction: float = CODE_FLIP_FRACTION) -> dict:
    """Hold wire rows ``got`` against ``want`` (same shape, ``n`` elements a
    row) to the parity rule: codes at most one apart, at most
    ``flip_fraction`` of them apart (a caller that sums the flips of many
    wires passes ``flip_fraction=1`` and holds the sum); with the encoded
    input ``x`` (..., n), a code at a tie (:data:`TIE_ATOL`) may differ
    beyond that fraction.  Raises AssertionError, else returns the counts
    and, per block, the bound the two decodes must keep
    (:func:`check_decoded`): ``s * (|dq|_2 + 2 SCALE_RTOL |q|_2)`` over the
    block's codes (the rotation is orthonormal, so a code step moves the
    decoded block by ``s`` in L2)."""
    if got.shape != want.shape:
        raise AssertionError(f"wire shapes {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    qg, sg = _fields(got, n, block)
    qw, sw = _fields(want, n, block)
    dq = (qg.to(torch.int16) - qw.to(torch.int16)).abs()
    ties = torch.zeros_like(dq, dtype=torch.bool)
    if x is not None:
        z = x.detach().cpu().double().reshape(dq.shape)
        if rotate:
            z = z @ ash_mod.hadamard_matrix(block, torch.float32).double()
        r = (z / sw.double()[..., None]).abs()
        ties = (r - r.floor() - 0.5).abs() <= TIE_ATOL
    flipped, codes = int((dq != 0).sum()), dq.numel()
    at_ties = int(((dq != 0) & ties).sum())
    if flipped - at_ties > flip_fraction * codes or int(dq.max()) > 1:
        raise AssertionError(f"int4 codes: {flipped} of {codes} differ, "
                             f"{at_ties} at ties (allowed "
                             f"{flip_fraction * codes:g} others), max "
                             f"distance {int(dq.max())}")
    rel = float(((sg - sw).abs() / sw.abs().clamp_min(1e-38)).max())
    if rel > SCALE_RTOL:
        raise AssertionError(f"int4 scales: rel err {rel} > {SCALE_RTOL}")
    bound = sw * (dq.float().norm(dim=-1)
                  + 2 * SCALE_RTOL * qw.float().norm(dim=-1))
    return {"flipped": flipped, "at_ties": at_ties, "codes": codes,
            "scale_rel_err": rel, "bound": bound}


def check_decoded(got: torch.Tensor, want: torch.Tensor,
                  bound: torch.Tensor, block: int) -> float:
    """Decoded rows ``got`` against ``want`` (..., n), block by block: the
    L2 distance of each block within ``bound`` (:func:`check_wire_parity`'s,
    summed over the peers for a peer sum) plus 1e-6 of the block's norm
    (the f32 rounding of the decode).  Returns the largest distance over
    its allowance."""
    g = got.cpu().float().reshape(*bound.shape, block)
    w = want.cpu().float().reshape(*bound.shape, block)
    dist = (g - w).norm(dim=-1)
    allowed = bound + 1e-6 * w.norm(dim=-1) + 1e-30
    worst = float((dist / allowed).max())
    if worst > 1.0:
        raise AssertionError(f"decoded block off by {worst:.3g}x its bound")
    return worst
