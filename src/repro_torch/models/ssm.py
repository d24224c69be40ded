"""Selective SSM (Mamba-style) branch of the hymba hybrid layer: the JAX
package's ``repro/models/ssm.py`` in PyTorch.

The d_inner channels shard over the model axis (aligned with hymba's
parallel attention heads); the recurrence over the sequence is a chunked
scan: log-depth within a chunk, the state carried from chunk to chunk.

State: h (B, d_inner_local, N).  Discretization: zero-order hold
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D_skip * x_t

The JAX package scans a chunk with ``jax.lax.associative_scan``; the port
runs the same odd-even recursion over ``(a, b)`` with the same combine
(each level combines neighbouring pairs, scans the pairs, and fills in
the even positions: log2(chunk) levels whose sizes halve), on every chunk
at once, then carries the state through the chunks in a Python loop: a
loop over time steps would launch S ops per layer and pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE


def ssm_specs(pb, name: str, cfg, plan):
    d = cfg.d_model
    di = d * cfg.ssm.expand
    n = cfg.ssm.d_state
    pb.add(f"{name}.w_in", (d, 2 * di), fsdp_dim=0, tp_dim=1)   # x and gate z
    pb.add(f"{name}.conv_w", (3, di), tp_dim=1, scale=0.1)      # depthwise k=3
    pb.add(f"{name}.w_bc", (di, 2 * n + 1), tp_dim=0, scale=0.01)  # B, C, dt
    pb.add(f"{name}.a_log", (di, n), tp_dim=0, init="zeros")
    pb.add(f"{name}.d_skip", (di,), tp_dim=0, init="ones")
    pb.add(f"{name}.dt_bias", (di,), tp_dim=0, init="zeros")
    pb.add(f"{name}.w_out", (di, d), fsdp_dim=1, tp_dim=0)


def _depthwise_conv3(x, w, prev):
    """x (B, S, C), w (3, C), prev (B, 2, C) last two tokens of the prior
    segment."""
    ext = torch.cat([prev, x], dim=1)
    return ext[:, :-2] * w[0] + ext[:, 1:-1] * w[1] + ext[:, 2:] * w[2]


def _scan(a, b):
    """Inclusive scan of ``combine((ax, bx), (ay, by)) = (ax * ay, by + ay
    * bx)`` along dim 1 by the odd-even recursion: returns ``(A, h)``,
    A_t the product a_0 ... a_t and h_t of ``h_t = a_t h_{t-1} + b_t``
    from h_{-1} = 0."""
    s = a.shape[1]
    if s == 1:
        return a, b
    m = s // 2
    a0, a1 = a[:, 0:2 * m:2], a[:, 1:2 * m:2]
    b0, b1 = b[:, 0:2 * m:2], b[:, 1:2 * m:2]
    # each pair (2i, 2i + 1) combined; their scan gives the odd positions
    a_odd, h_odd = _scan(a1 * a0, b1 + a1 * b0)
    # an even position 2i > 0 follows the odd position 2i - 1
    a2, b2 = a[:, 2:2 * m:2], b[:, 2:2 * m:2]
    a_even = torch.cat([a[:, :1], a2 * a_odd[:, :-1]], dim=1)
    h_even = torch.cat([b[:, :1], b2 + a2 * h_odd[:, :-1]], dim=1)
    out_a = torch.stack([a_even, a_odd], dim=2).flatten(1, 2)
    out_h = torch.stack([h_even, h_odd], dim=2).flatten(1, 2)
    if s % 2:                              # a last, unpaired position
        out_a = torch.cat([out_a, a[:, -1:] * out_a[:, -1:]], dim=1)
        out_h = torch.cat([out_h, b[:, -1:] + a[:, -1:] * out_h[:, -1:]],
                          dim=1)
    return out_a, out_h


def _assoc_scan_chunked(a, b, h0, chunk: int):
    """Linear recurrence h_t = a_t * h_{t-1} + b_t over dim 1.
    a, b (B, S, C, N), h0 (B, C, N) -> (h (B, S, C, N), h_final); the state
    is carried from chunk to chunk.  A chunk that does not divide S falls
    back to one chunk of S, as the JAX package's.

    Every chunk is scanned from a zero state at once (the chunks are a
    batch dim), then the carried state enters each chunk in turn:
    ``h_t = H_t + A_t h_in``, the same sum as the JAX package's fold of
    h_in into the chunk's first step, in another order of rounding."""
    bsz, s = a.shape[:2]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    nc = s // chunk
    rest = a.shape[2:]
    big_a, big_h = (t.reshape(bsz * nc, chunk, *rest) for t in _scan(
        a.reshape(bsz * nc, chunk, *rest), b.reshape(bsz * nc, chunk, *rest)))
    big_a = big_a.reshape(bsz, nc, chunk, *rest)
    big_h = big_h.reshape(bsz, nc, chunk, *rest)
    h, outs = h0, []
    for k in range(nc):
        hs = big_h[:, k] + big_a[:, k] * h[:, None]
        h = hs[:, -1]
        outs.append(hs)
    return (outs[0] if nc == 1 else torch.cat(outs, dim=1)), h


def ssm_apply(x_full, p, cfg, plan, ctx, *, state=None, chunk=256):
    """x_full (B, S, D) -> (tp-partial out (B, S, D), new_state).

    state (decode): {conv (B, 2, C_loc), h (B, C_loc, N)}; None trains
    from zeros."""
    b, s, _ = x_full.shape
    n = cfg.ssm.d_state
    w_in = ctx.weight_gather(p["w_in"], 0)
    w_out = ctx.weight_gather(p["w_out"], 1)
    xz = x_full @ w_in
    di_loc = xz.shape[-1] // 2
    x_in, z = xz[..., :di_loc], xz[..., di_loc:]

    prev = state["conv"].to(x_in.dtype) if state is not None else \
        torch.zeros((b, 2, di_loc), dtype=x_in.dtype, device=x_in.device)
    xc = F.silu(_depthwise_conv3(x_in, p["conv_w"].to(x_in.dtype), prev))
    bcd = (xc @ p["w_bc"].to(xc.dtype)).float()
    b_t, c_t, dt = bcd[..., :n], bcd[..., n:2 * n], bcd[..., 2 * n:]
    dt = F.softplus(dt + p["dt_bias"].float())                    # (B,S,1)
    a = -torch.exp(p["a_log"].float())                            # (C,N)
    xf = xc.float()

    decay = torch.exp(dt[..., None] * a[None, None])              # (B,S,C,N)
    drive = (dt * xf)[..., None] * b_t[:, :, None, :]             # (B,S,C,N)

    h0 = state["h"] if state is not None else torch.zeros(
        (b, di_loc, n), dtype=torch.float32, device=x_full.device)
    if s == 1:
        h_fin = decay[:, 0] * h0 + drive[:, 0]
        hs = h_fin[:, None]
    else:
        hs, h_fin = _assoc_scan_chunked(decay, drive, h0, chunk)
    y = torch.einsum("bscn,bsn->bsc", hs, c_t) + xf * p["d_skip"].float()
    y = y.to(COMPUTE_DTYPE) * F.silu(z)
    out = y @ w_out                                               # tp-partial
    new_state = {"conv": torch.cat([prev, x_in], dim=1)[:, -2:],
                 "h": h_fin}
    return out, new_state
