"""Plain PyTorch versions of the TACO operators (the oracle).

The CUDA kernels in ``ash_compress.py`` / ``ash_decompress.py`` are held
against these functions on the card, and the CPU path runs them.  Block
layout everywhere: blocks (M, B), alpha (M,), s (M, G) with
G = B / quant_group_size.

The three wire forms are the block forms composed with the wire packing
(``repro_torch.core.codecs.pack_wire`` / ``unpack_wire``), which defines
the byte layout both packages share.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ash as ash_mod
from repro_torch.core import quant as quant_mod


def _transform_fwd(blocks, cfg):
    """-> (z, alpha) applying cfg.transform."""
    cd = cfg.torch_compute_dtype
    g = blocks.to(cd)
    ones = torch.ones((blocks.shape[0],), dtype=cd, device=blocks.device)
    if cfg.transform == "ash":
        return ash_mod.ash_forward(g, tau=cfg.tau, eps=cfg.eps,
                                   compute_dtype=cd)
    if cfg.transform == "hadamard":
        h = ash_mod.hadamard_matrix(blocks.shape[-1], cd, blocks.device)
        return ash_mod._rotate(g, h), ones
    if cfg.transform == "none":
        return g, ones
    raise ValueError(cfg.transform)


def plain_bits(cfg) -> bool:
    """Whether K1 and K2 give this plain version's bits for ``cfg``: the
    ash transform with block-or-finer scales (the kernels' configurations)
    at an f32 compute dtype."""
    return cfg.transform == "ash" and cfg.scale_granularity == "block" \
        and cfg.compute_dtype == "float32"


def _compress_blocks_f32(blocks: torch.Tensor, cfg):
    """K1's function at an f32 compute dtype, in one order on every device
    (each step rounded once, as ``compress_segment`` in csrc/ash_common.cuh):
    sigma = sqrt(pairwise_sum(g^2) / B + eps), alpha = tau / sigma, z =
    fwht(alpha g) * (1/sqrt(B)) in f64 on the f32 products alpha g, rounded
    once to f32 (the values of an f64 matmul rounded once), per group s =
    max(max|z| / qmax, scale_eps), then the cast (fp8) or round half to
    even (int8) of clip(z / s, +-qmax), NaN's int8 code 0.  The maxima,
    the floor and the clip keep NaN, so a row holding a NaN or an inf has
    NaN scales (and fp8 codes).  The row's bits do not depend on the row
    count or the device."""
    fmt = cfg.format_spec
    m, b = blocks.shape
    g = blocks.float()
    # the square root of an f32 in f64, rounded once, is the correctly
    # rounded f32 root (the kernel's sqrtf); PyTorch's f32 sqrt on the CPU
    # is not always
    sigma = torch.sqrt((pairwise_sum(g * g) / b + cfg.eps).double()).float()
    alpha = torch.div(torch.tensor(cfg.tau, dtype=torch.float32,
                                   device=g.device), sigma)
    z = (ash_mod.fwht((alpha[:, None] * g).double())
         * (1.0 / np.sqrt(b))).float()
    gs = cfg.quant_group_size or b
    zg = quant_mod._group(z, gs)
    # tensor divisors: true divisions on every device (PyTorch computes a
    # CUDA tensor over a Python scalar as a product with its reciprocal)
    qmax = torch.tensor(fmt.qmax, dtype=torch.float32, device=g.device)
    s = torch.clamp_min(zg.abs().amax(dim=-1) / qmax, cfg.scale_eps)
    scaled = torch.clamp(zg / s[..., None], -fmt.qmax, fmt.qmax)
    q = scaled.to(fmt.dtype) if fmt.is_float else \
        quant_mod.int8_codes(scaled)
    return q.reshape(m, b), alpha, s


def compress_blocks_ref(blocks: torch.Tensor, cfg):
    """(M, B) -> (q storage-dtype (M,B), alpha (M,) f32, s (M,G) f32).

    Where :func:`plain_bits` holds, :func:`_compress_blocks_f32`.  The
    metadata is f32 whatever the compute dtype, as the wire layout
    (``taco.wire_components``) declares it: a bf16 compute dtype's alpha
    and s widen exactly."""
    if plain_bits(cfg):
        return _compress_blocks_f32(blocks, cfg)
    fmt = cfg.format_spec
    z, alpha = _transform_fwd(blocks, cfg)
    if cfg.scale_granularity == "tensor":
        s_val = torch.clamp_min(z.abs().amax() / fmt.qmax, cfg.scale_eps)
        s = s_val.repeat(blocks.shape[0], 1)     # owns its storage
        scaled = torch.clamp(z / s_val, -fmt.qmax, fmt.qmax)
        q = scaled.to(fmt.dtype) if fmt.is_float else \
            quant_mod.int8_codes(scaled)
        return q, alpha.float(), s.float()
    q, s = quant_mod.quantize_ds(z, fmt, group_size=cfg.quant_group_size,
                                 eps=cfg.scale_eps)
    return q, alpha.float(), s.float()


def decompress_blocks_ref(q, s, alpha, cfg) -> torch.Tensor:
    """(q, s, alpha|None) -> reconstructed blocks (M, B) in compute dtype.
    alpha=None means folded metadata: s already carries s/alpha."""
    cd = cfg.torch_compute_dtype
    z = quant_mod.dequantize_ds(q, s, cfg.format_spec, compute_dtype=cd)
    if cfg.transform in ("ash", "hadamard"):
        g = ash_mod._rotate(z, ash_mod.hadamard_matrix(q.shape[-1], cd,
                                                       q.device))
    else:
        g = z
    if alpha is not None and cfg.transform == "ash":
        g = g / alpha[:, None].to(cd)
    return g


def decompress_reduce_ref(q, s, alpha, cfg) -> torch.Tensor:
    """Sum-of-peers decompression: q (P, M, B), s (P, M, G), alpha (P, M)
    or None -> sum_p decompress(q_p, s_p, alpha_p), peers in index order."""
    out = None
    for p in range(q.shape[0]):
        a = None if alpha is None else alpha[p]
        g = decompress_blocks_ref(q[p], s[p], a, cfg)
        out = g if out is None else out + g
    return out


#: the scale floor of the butterfly compress (K7), fixed in the reference
BUTTERFLY_SCALE_FLOOR = 1e-30


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as a pairwise tree of
    adjacent pairs: level k adds the sums of neighbouring blocks of 2^k.
    One order on every device, which K7 follows lane by lane."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def compress_blocks_butterfly_ref(blocks: torch.Tensor, cfg):
    """K7's function: (M, B) -> (q storage-dtype (M, B), alpha (M,),
    s (M, 1)).  ASH with alpha applied before the rotation (the sum of
    squares by :func:`pairwise_sum`), the butterfly ``ash.fwht`` scaled by
    1/sqrt(B), ONE block-level scale floored at
    :data:`BUTTERFLY_SCALE_FLOOR` (not ``cfg.scale_eps``), clip to +-qmax,
    then the cast (fp8) or round half to even (int8).  Only ``tau``,
    ``eps`` and ``fmt`` of ``cfg`` are read, as in the reference."""
    fmt = cfg.format_spec
    b = blocks.shape[-1]
    g = blocks.float()
    # the root in f64, rounded once (the kernel's sqrtf), as
    # _compress_blocks_f32 takes it
    sigma = torch.sqrt((pairwise_sum(g * g) / b + cfg.eps).double()).float()
    alpha = torch.div(torch.tensor(cfg.tau, dtype=torch.float32,
                                   device=g.device), sigma)
    z = ash_mod.fwht(alpha[:, None] * g) * float(np.float32(1.0 / b ** 0.5))
    # a tensor divisor: a true division on every device (PyTorch computes
    # a CUDA tensor over a Python scalar as a product with its reciprocal)
    qmax = torch.tensor(fmt.qmax, dtype=torch.float32, device=g.device)
    s = torch.clamp_min(z.abs().amax(dim=-1) / qmax, BUTTERFLY_SCALE_FLOOR)
    scaled = torch.clamp(z / s[:, None], -fmt.qmax, fmt.qmax)
    q = scaled.to(fmt.dtype) if fmt.is_float else \
        quant_mod.int8_codes(scaled)
    return q, alpha, s[:, None]


def blocks_to_wire(q, alpha, s, cfg, slots: int, n: int) -> torch.Tensor:
    """Block-form arrays (q (M, B), alpha (M,), s (M, G)) -> the packed wire
    rows (slots, total) of ``cfg``'s layout for ``n`` elements per slot:
    how a block kernel's output is held to :func:`check_wire_parity`."""
    from repro_torch.core import codecs, taco
    pay = taco._storage_to_wire(q, cfg.format_spec).reshape(slots, n)
    if cfg.metadata == "folded":
        enc = (pay, (s / alpha[:, None]).reshape(slots, -1))
    else:
        enc = (pay, s.reshape(slots, -1), alpha.reshape(slots, -1))
    return codecs.pack_wire(enc, _layout(cfg, n))


# --------------------------------------------------------------------------
# wire forms: pack/unpack composed with the block forms
# --------------------------------------------------------------------------

def _layout(cfg, n):
    from repro_torch.core import codecs, taco
    return codecs.make_wire_layout(*taco.wire_components(cfg, n))


def _block_fields(wire, n, cfg):
    """Wire rows (R, total) -> q (R, mb, B) storage dtype, scale
    (R, mb, G), alpha (R, mb) | None."""
    from repro_torch.core import codecs, taco
    b = cfg.block_size
    rows, mb = wire.shape[0], n // b
    fields = codecs.unpack_wire(wire, _layout(cfg, n))
    q = taco._wire_to_storage(fields[0], cfg.format_spec).reshape(rows, mb, b)
    s = fields[1].reshape(rows, mb, -1)
    alpha = fields[2].reshape(rows, mb) if len(fields) == 3 else None
    return q, s, alpha


def compress_wire_ref(x: torch.Tensor, cfg) -> torch.Tensor:
    """(slots, n) -> (slots, total_bytes) uint8 wire rows."""
    from repro_torch.core import codecs, taco
    slots, n = x.shape
    b = cfg.block_size
    mb = n // b
    q, alpha, s = compress_blocks_ref(x.reshape(slots * mb, b), cfg)
    payload = taco._storage_to_wire(q, cfg.format_spec).reshape(slots, n)
    if cfg.metadata == "folded":
        enc = (payload, (s / alpha[:, None]).reshape(slots, -1))
    else:
        enc = (payload, s.reshape(slots, -1), alpha.reshape(slots, mb))
    return codecs.pack_wire(enc, _layout(cfg, n))


def decompress_wire_ref(wire: torch.Tensor, n: int, cfg) -> torch.Tensor:
    """(slots, total_bytes) uint8 -> (slots, n) in the compute dtype."""
    slots = wire.shape[0]
    q, s, alpha = _block_fields(wire, n, cfg)
    b = cfg.block_size
    out = decompress_blocks_ref(
        q.reshape(-1, b), s.reshape(q.shape[0] * q.shape[1], -1),
        None if alpha is None else alpha.reshape(-1), cfg)
    return out.reshape(slots, n)


def decompress_reduce_wire_ref(wire: torch.Tensor, n: int,
                               cfg) -> torch.Tensor:
    """Peer-stacked wire rows (P, total_bytes) -> peer sum (mb, B)."""
    q, s, alpha = _block_fields(wire, n, cfg)
    return decompress_reduce_ref(q, s, alpha, cfg)


# --------------------------------------------------------------------------
# the parity rule between two implementations of these operators
# --------------------------------------------------------------------------
# The compress kernels K1, K2 (where plain_bits holds) and K7 round each
# product and sum once, in their plain versions' order, so on the card
# they give these functions' bits: codes, alpha and s.  The rule below is
# a tolerance for what is computed in another order: the JAX package
# against the port (its rotation is an f32 matmul), a bf16 compute dtype,
# and the decompress forms (the kernels' butterfly against the plain f64
# rotation), where an element whose scaled value sits on a rounding
# boundary can land one code apart: at most PAYLOAD_FLIP_FRACTION of the
# payload bytes may differ, each by at most one code (so a comparison of
# fewer than 1/PAYLOAD_FLIP_FRACTION bytes must match exactly); scales and
# alpha within META_RTOL; decoded values within DECODE_RTOL / DECODE_ATOL.
PAYLOAD_FLIP_FRACTION = 1e-4
META_RTOL = 1e-5
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5
# A bf16 compute dtype rounds z, alpha and s to bf16 (8 significant bits):
# a reduction or matmul that sums in another order moves a value by one
# bf16 ulp (at most 2^-7 relative), and with it the codes that sit near a
# boundary.  Such a configuration is held to these allowances instead.
BF16_FLIP_FRACTION = 1e-3
BF16_RTOL = 2.0 ** -7


def _allowances(cfg) -> tuple[float, float]:
    """(payload flip fraction, metadata rtol) of the parity rule for
    ``cfg``'s compute dtype."""
    if cfg.compute_dtype == "bfloat16":
        return BF16_FLIP_FRACTION, BF16_RTOL
    return PAYLOAD_FLIP_FRACTION, META_RTOL


def payload_codes(payload: torch.Tensor, cfg) -> torch.Tensor:
    """Payload bytes -> signed code indices, so that neighbouring
    representable values differ by one (fp8 bytes are sign-magnitude;
    +0 and -0 both map to 0)."""
    b = payload.to(torch.int64)
    if not cfg.format_spec.is_float:
        return torch.where(b > 127, b - 256, b)
    mag = b & 0x7F
    return torch.where(b >= 0x80, -mag, mag)


def check_wire_parity(got: torch.Tensor, want: torch.Tensor, n: int,
                      cfg) -> dict:
    """Hold wire rows ``got`` against ``want`` (same layout for ``n``) to
    the parity rule; raises AssertionError, else returns the counts."""
    if got.shape != want.shape:
        raise AssertionError(f"wire shapes {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want = got.cpu(), want.cpu()
    dq = (payload_codes(got[..., :n], cfg)
          - payload_codes(want[..., :n], cfg)).abs()
    flip_fraction, meta_rtol = _allowances(cfg)
    flipped = int((dq != 0).sum())
    allowed = flip_fraction * dq.numel()
    if flipped > allowed or (flipped and int(dq.max()) > 1):
        raise AssertionError(
            f"payload: {flipped} of {dq.numel()} bytes differ (allowed "
            f"{allowed:g}), max code distance {int(dq.max())}")
    from repro_torch.core import codecs
    layout = _layout(cfg, n)
    meta_err = 0.0
    for g, w in zip(codecs.unpack_wire(got, layout)[1:],
                    codecs.unpack_wire(want, layout)[1:]):
        rel = ((g - w).abs() / w.abs().clamp_min(1e-38)).max()
        meta_err = max(meta_err, float(rel))
    if meta_err > meta_rtol:
        raise AssertionError(f"wire metadata rel err {meta_err} > "
                             f"{meta_rtol}")
    return {"flipped": flipped, "meta_rel_err": meta_err}


def check_compress_wire(got: torch.Tensor, want: torch.Tensor, n: int,
                        cfg) -> dict:
    """A compress kernel's wire rows ``got`` (K2, or pack of K1) against the
    plain version's ``want`` on the same inputs: byte for byte where
    :func:`plain_bits` holds (raises with the codes apart), else the parity
    rule.  Returns :func:`check_wire_parity`'s counts and ``bitwise``."""
    if plain_bits(cfg):
        got, want = got.cpu(), want.cpu()
        if not torch.equal(got, want):
            dq = (payload_codes(got[..., :n], cfg)
                  - payload_codes(want[..., :n], cfg)).abs()
            meta = int((got[..., n:] != want[..., n:]).sum())
            raise AssertionError(
                f"not the plain version's bits: {int((dq != 0).sum())} of "
                f"{dq.numel()} codes differ, max {int(dq.max())} apart; "
                f"{meta} metadata bytes differ")
        return {"flipped": 0, "meta_rel_err": 0.0, "bitwise": True}
    stats = check_wire_parity(got, want, n, cfg)
    return dict(stats, bitwise=torch.equal(got.cpu(), want.cpu()))


def check_decoded_close(got: torch.Tensor, want: torch.Tensor,
                        cfg=None) -> float:
    """Decoded values within DECODE_RTOL / DECODE_ATOL, or, under a bf16
    compute dtype of ``cfg``, within BF16_RTOL in relative norm (a sum that
    rounds once where the plain version rounds each term lands a few bf16
    ulps apart); returns max abs error."""
    got, want = got.cpu().float(), want.cpu().float()
    if cfg is not None and cfg.compute_dtype == "bfloat16":
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        if err > BF16_RTOL:
            raise AssertionError(f"decoded relative error {err} > "
                                 f"{BF16_RTOL}")
    else:
        torch.testing.assert_close(got, want, rtol=DECODE_RTOL,
                                   atol=DECODE_ATOL)
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_hop_parity(codec, x: torch.Tensor, device) -> dict:
    """One compressed hop of ``codec`` on the (slots, n) input ``x``, run on
    ``device`` against the same hop on the CPU: the encoded wire rows
    (``encode_wire``) under :func:`check_compress_wire` (bit for bit where
    :func:`plain_bits` holds, else the parity rule), and the CPU's wire
    decoded on both (``decode_wire``, and ``decode_sum_wire`` with the
    slots as peers), each within the decode rtol of ``cfg``'s compute dtype
    (DECODE_RTOL, or BF16_RTOL) in relative norm.  Returns the wire counts
    and the decode errors."""
    cfg = codec.cfg
    n = x.shape[-1]
    x = x.cpu()
    w_cpu = codec.encode_wire(x)
    stats = check_compress_wire(codec.encode_wire(x.to(device)), w_cpu, n,
                                cfg)
    rtol = BF16_RTOL if cfg.compute_dtype == "bfloat16" else DECODE_RTOL
    for name, fn in (
            ("decode", lambda w: codec.decode_wire(w, n, torch.float32)),
            ("decode_sum",
             lambda w: codec.decode_sum_wire(w, n, torch.float32))):
        got, want = fn(w_cpu.to(device)).cpu(), fn(w_cpu)
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        if err > rtol:
            raise AssertionError(f"{name}: {device} vs cpu relative error "
                                 f"{err} > {rtol}")
        stats[f"{name}_rel_err"] = err
    return stats


# --------------------------------------------------------------------------
# rows holding NaN or inf
# --------------------------------------------------------------------------
# A row holding a NaN, or an inf (whose sum of squares gives alpha 0, and
# 0 inf is NaN), rotates to NaN at every element: its scales are NaN, its
# fp8 codes NaN bytes and its int8 codes 0 (quant.int8_codes), in every
# compress kernel and plain version of both packages.  A compress kernel
# is held to its plain version there by NONFINITE_RULE, and its decoded
# rows by check_decoded_nonfinite.

#: what plant_nonfinite writes into its rows, in order
NONFINITE_KINDS = ("nan", "+inf", "-inf", "3e19", "zero")
NONFINITE_RULE = ("alpha and s bit for bit, or NaN on both sides; int8 "
                  "codes equal; fp8 bytes equal, or a NaN byte of the "
                  "format on both sides")


def plant_nonfinite(x: torch.Tensor, gen):
    """A copy of the rows ``x`` (M, B), M >= 5, with distinct rows drawn
    from the numpy generator ``gen`` made, in the order of
    :data:`NONFINITE_KINDS`: one element NaN, one +inf, one -inf (at drawn
    columns); zeros but one element of 3e19 (its square overflows f32:
    sigma inf, alpha 0, every code 0); all zeros.  Returns (the copy, the
    rows as a list)."""
    m, b = x.shape
    rows = [int(r) for r in gen.choice(m, len(NONFINITE_KINDS),
                                       replace=False)]
    x = x.clone()
    cols = gen.integers(0, b, size=len(NONFINITE_KINDS))
    for r, c, val in zip(rows[:3], cols, (float("nan"), float("inf"),
                                          float("-inf"))):
        x[r, int(c)] = val
    x[rows[3]] = 0
    x[rows[3], int(cols[3])] = 3e19
    x[rows[4]] = 0
    return x, rows


def nonfinite_apart(got, want, fmt) -> torch.Tensor:
    """Per row, how many codes, scales and alphas of ``got`` = (q (M, B),
    alpha (M,) or None, s (M, G)) lie apart from ``want``'s under
    :data:`NONFINITE_RULE` (a NaN's byte is the card's own canonical NaN
    or the sign of the NaN PyTorch's cast is given; both are NaN)."""
    def same_f32(g, w):
        g, w = g.cpu().float(), w.cpu().float()
        return (g.view(torch.int32) == w.view(torch.int32)) | \
            (g.isnan() & w.isnan())

    def fp8_nan(q):                 # e4m3 S.1111.111, e5m2 S.11111.xx, xx > 0
        mag = q.view(torch.uint8).to(torch.int32) & 0x7F
        return mag == 0x7F if fmt.name == "e4m3" else mag > 0x7C

    qg, qw = got[0].cpu(), want[0].cpu()
    m = qg.shape[0]
    if fmt.is_float:
        ok = (qg.view(torch.uint8) == qw.view(torch.uint8)) | \
            (fp8_nan(qg) & fp8_nan(qw))
    else:
        ok = qg == qw
    apart = (~ok).reshape(m, -1).sum(-1)
    apart += (~same_f32(got[2].reshape(m, -1),
                        want[2].reshape(m, -1))).sum(-1)
    if got[1] is not None or want[1] is not None:
        apart += (~same_f32(got[1], want[1])).reshape(m).long()
    return apart


def check_decoded_nonfinite(got: torch.Tensor, want: torch.Tensor,
                            cfg=None) -> float:
    """Decoded values of rows that may hold NaN or inf: NaN at the same
    elements, each inf equal, the finite rest by
    :func:`check_decoded_close`; returns its max abs error."""
    got, want = got.cpu().float(), want.cpu().float()
    nan_apart = int((got.isnan() != want.isnan()).sum())
    inf = got.isinf() | want.isinf()
    if nan_apart or not torch.equal(got[inf], want[inf]):
        raise AssertionError(f"NaN at {nan_apart} elements apart, infs at "
                             f"{int((got[inf] != want[inf]).sum())}")
    fin = got.isfinite() & want.isfinite()
    return check_decoded_close(got[fin], want[fin], cfg)


def _rows_wire(q, alpha, s, cfg) -> torch.Tensor:
    """Rows (q, alpha, s) as one wire row of ``cfg``'s layout; alpha None:
    folded fields, s already s / alpha."""
    if alpha is not None:
        return blocks_to_wire(q, alpha, s, cfg, 1, q.numel())
    from repro_torch.core import codecs, taco
    pay = taco._storage_to_wire(q, cfg.format_spec).reshape(1, -1)
    return codecs.pack_wire((pay, s.reshape(1, -1)), _layout(cfg, q.numel()))


def wire_fields(wire: torch.Tensor, n: int, cfg) -> tuple:
    """Wire rows -> (q (M, B), alpha (M,) or None, scale field (M, G)) a
    block row (the scale field: s, or s / alpha when folded)."""
    q, s, a = _block_fields(wire, n, cfg)
    return (q.reshape(-1, cfg.block_size), None if a is None
            else a.reshape(-1), s.reshape(q.shape[0] * q.shape[1], -1))


def check_compress_nonfinite(got, want, cfg, planted_rows,
                             bits: bool) -> int:
    """A compress kernel's ``got`` = (q (M, B), alpha (M,) or None, s (M,
    G)) against its plain version's ``want``, on rows of which
    ``planted_rows`` hold :data:`NONFINITE_KINDS`: those rows under
    :data:`NONFINITE_RULE`, and so every row where the kernel gives the
    plain version's ``bits`` (K1 and K2 where :func:`plain_bits`, K7); the
    other rows under the parity rule.  Raises AssertionError; returns the
    values apart (0)."""
    apart = nonfinite_apart(got, want, cfg.format_spec)
    m = len(apart)
    exact = list(range(m)) if bits else list(planted_rows)
    bad = int(apart[exact].sum())
    if bad:
        raise AssertionError(
            f"{bad} values apart in rows {[r for r in exact if apart[r]]} "
            f"({NONFINITE_RULE})")
    if not bits:
        keep = [r for r in range(m) if r not in planted_rows]
        g, w = (_rows_wire(o[0][keep], None if o[1] is None else o[1][keep],
                           o[2].reshape(m, -1)[keep], cfg)
                for o in (got, want))
        check_wire_parity(g, w, len(keep) * got[0].shape[1], cfg)
    return bad


def check_kernels_nonfinite(x: torch.Tensor, cfg, planted_rows) -> dict:
    """K1-K7 on the rows ``x`` (M, B), M even, of which ``planted_rows``
    hold :data:`NONFINITE_KINDS` (``plant_nonfinite``), against their plain
    versions on ``x``'s device: K1 (``compress_blocks``), K2
    (``compress_wire`` of the rows as two slots) and K7
    (``compress_blocks_butterfly``, which reads only ``cfg``'s tau, eps
    and format) by :func:`check_compress_nonfinite`; K3 and K4 (the rows
    as two peers) on the plain version's blocks and K5 and K6 on its wire
    by :func:`check_decoded_nonfinite`.  Returns the kernels held and the
    values apart (raises where any is)."""
    from repro_torch.kernels import ash_compress, ash_decompress
    from repro_torch.kernels import fwht_butterfly
    b, m = cfg.block_size, x.shape[0]
    n = m // 2 * b
    bits = plain_bits(cfg)
    qp, ap, sp = want = compress_blocks_ref(x, cfg)
    apart = check_compress_nonfinite(ash_compress.compress_blocks(x, cfg),
                                     want, cfg, planted_rows, bits)
    wire = compress_wire_ref(x.reshape(2, n), cfg)
    apart += check_compress_nonfinite(
        wire_fields(ash_compress.compress_wire(x.reshape(2, n), cfg), n, cfg),
        wire_fields(wire, n, cfg), cfg, planted_rows, bits)
    apart += check_compress_nonfinite(
        fwht_butterfly.compress_blocks_butterfly(x, cfg),
        compress_blocks_butterfly_ref(x, cfg), cfg, planted_rows, True)
    alpha = None if cfg.metadata == "folded" else ap
    scale = sp / ap[:, None] if alpha is None else sp
    peers = (qp.reshape(2, m // 2, b), scale.reshape(2, m // 2, -1),
             None if alpha is None else alpha.reshape(2, m // 2))
    for kern, plain, args in (
            (ash_decompress.decompress_blocks, decompress_blocks_ref,
             (qp, scale, alpha)),
            (ash_decompress.decompress_reduce, decompress_reduce_ref, peers),
            (ash_decompress.decompress_wire, decompress_wire_ref, (wire, n)),
            (ash_decompress.decompress_reduce_wire,
             decompress_reduce_wire_ref, (wire, n))):
        check_decoded_nonfinite(kern(*args, cfg), plain(*args, cfg), cfg)
    return {"kernels": 7, "apart": apart}
