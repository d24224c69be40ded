"""RWKV6 "Finch" block (attention-free, data-dependent decay): the JAX
package's ``repro/models/rwkv.py`` in PyTorch.

TP sharding: the heads (d_model / 64) shard over the model axis; the
residual stream stays sequence-parallel, so the block has the dense
block's compressed gather / scatter sites (attention-free is not
TP-communication-free).

Time-mix recurrence (per head, state S in R^{c x c}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Computed in chunks: the intra-chunk pair scores use the *bounded* decay
ratio exp(logA_{t-1} - logA_j) <= 1 evaluated jointly (never the
unbounded k / A_j factorization, which overflows f32 on long sequences),
the inter-chunk term the carried state; a Python loop over the chunks.
Every clip of the JAX package is kept where it has it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE

LORA_MIX = 32
LORA_W = 64
N_STREAMS = 5  # w, k, v, r, g


def rwkv_specs(pb, name: str, cfg, plan):
    d, f = cfg.d_model, cfg.d_ff
    # time-mix
    pb.add(f"{name}.tm.mu_x", (d,), init="zeros")
    pb.add(f"{name}.tm.mu", (N_STREAMS, d), init="zeros")
    pb.add(f"{name}.tm.lora_a", (d, N_STREAMS * LORA_MIX), scale=0.01)
    pb.add(f"{name}.tm.lora_b", (N_STREAMS, LORA_MIX, d), init="zeros")
    pb.add(f"{name}.tm.w0", (d,), tp_dim=0, init="zeros")
    pb.add(f"{name}.tm.wa", (d, LORA_W), scale=0.01)
    pb.add(f"{name}.tm.wb", (LORA_W, d), tp_dim=1, init="zeros")
    pb.add(f"{name}.tm.u", (d,), tp_dim=0, init="zeros")
    pb.add(f"{name}.tm.wr", (d, d), fsdp_dim=0, tp_dim=1)
    pb.add(f"{name}.tm.wk", (d, d), fsdp_dim=0, tp_dim=1)
    pb.add(f"{name}.tm.wv", (d, d), fsdp_dim=0, tp_dim=1)
    pb.add(f"{name}.tm.wg", (d, d), fsdp_dim=0, tp_dim=1)
    pb.add(f"{name}.tm.wo", (d, d), fsdp_dim=1, tp_dim=0)
    pb.add(f"{name}.tm.ln_scale", (d,), tp_dim=0, init="zeros")
    pb.add(f"{name}.tm.ln_bias", (d,), tp_dim=0, init="zeros")
    # channel-mix
    pb.add(f"{name}.cm.mu_k", (d,), init="zeros")
    pb.add(f"{name}.cm.mu_r", (d,), init="zeros")
    pb.add(f"{name}.cm.wk", (d, f), fsdp_dim=0, tp_dim=1)
    pb.add(f"{name}.cm.wv", (f, d), fsdp_dim=1, tp_dim=0)
    pb.add(f"{name}.cm.wr", (d, d), fsdp_dim=0)  # gate needs full D: replicated


def _token_shift(x, prev):
    """x (B, S, D); prev (B, 1, D) last token of the previous segment
    (zeros at BOS)."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix_streams(x, xx, p):
    sx = xx - x
    xxx = x + sx * p["mu_x"].to(x.dtype)
    lo = torch.tanh(xxx @ p["lora_a"])                      # (B,S,5*r)
    b, s, _ = lo.shape
    lo = lo.reshape(b, s, N_STREAMS, LORA_MIX)
    delta = torch.einsum("bsnr,nrd->bsnd", lo, p["lora_b"])
    mixed = x[:, :, None] + sx[:, :, None] * (
        p["mu"].to(x.dtype)[None, None] + delta.to(x.dtype))
    return [mixed[:, :, i] for i in range(N_STREAMS)]       # w,k,v,r,g


def _heads(x, hd):
    b, s, d = x.shape
    return x.reshape(b, s, d // hd, hd)


def _group_norm(o, scale, bias, eps=64e-5):
    """Per-head normalization (RWKV ln_x). o (B, S, H, hd); the
    population variance, as ``jnp.var``."""
    of = o.float()
    mu = of.mean(dim=-1, keepdim=True)
    var = of.var(dim=-1, keepdim=True, correction=0)
    out = (of - mu) * torch.rsqrt(var + eps)
    h, hd = o.shape[2], o.shape[3]
    out = out * (1.0 + scale.float().reshape(h, hd))
    out = out + bias.float().reshape(h, hd)
    return out.to(o.dtype)


def _chunk_recurrence(r, k, v, logw, u, s0, chunk: int):
    """r, k, v (B, S, H, c); logw (B, S, H, c) the log decay; u (H, c);
    s0 (B, H, c, c).  Returns (o (B, S, H, c) in the compute dtype,
    s_final f32).  A chunk that does not divide S falls back to one chunk
    of S, as the JAX package's."""
    s = r.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    eye = torch.eye(chunk, dtype=torch.float32, device=r.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), -1)
    uf = u.float()
    s_in, outs = s0.float(), []
    for i in range(0, s, chunk):
        rc, kc, vc, lwc = (t[:, i:i + chunk].float() for t in (r, k, v, logw))
        la = torch.cumsum(lwc, dim=1)                       # logA_t (B,C,H,c)
        la_prev = la - lwc                                  # logA_{t-1}
        # intra-chunk: bounded ratio exp(logA_{t-1} - logA_j), j < t
        ratio = torch.exp(torch.clamp(
            la_prev[:, :, None] - la[:, None, :], -60.0, 0.0))  # (B,t,j,H,c)
        scores = ((rc[:, :, None] * kc[:, None]) * ratio).sum(-1) \
            .permute(0, 3, 1, 2)                            # (B,H,t,j)
        scores = scores * tri
        diag = torch.einsum("bthc,hc,bthc->bht", rc, uf, kc)
        scores = scores + eye * diag[..., None]
        o_intra = torch.einsum("bhtj,bjhc->bthc", scores, vc)
        # inter-chunk: o += (r .* exp(logA_{t-1}))^T S_0
        r_dec = rc * torch.exp(torch.clamp(la_prev, -60.0, 0.0))
        o_inter = torch.einsum("bthc,bhcv->bthv", r_dec, s_in)
        # state update: S = diag(A_C) S_0 + sum_j (k_j .* A_C / A_j) v_j^T
        a_end = la[:, -1]                                   # (B,H,c)
        k_dec = kc * torch.exp(torch.clamp(a_end[:, None] - la, -60.0, 0.0))
        s_in = torch.exp(torch.clamp(a_end, -60.0, 0.0))[..., None] * s_in \
            + torch.einsum("bjhc,bjhv->bhcv", k_dec, vc)
        outs.append((o_intra + o_inter).to(COMPUTE_DTYPE))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o, s_in


def time_mix_apply(x_full, p, cfg, plan, ctx, *, state=None, chunk=64):
    """x_full (B, S, D) -> (tp-partial out (B, S, D), new_state).

    state (decode): {shift (B, 1, D), s (B, H_loc, c, c)}; None trains
    from zeros."""
    b, s, d = x_full.shape
    hd = cfg.hd
    h_loc = plan.q_local
    tm = p["tm"]
    prev = state["shift"].to(x_full.dtype) if state is not None else \
        torch.zeros((b, 1, d), dtype=x_full.dtype, device=x_full.device)
    xx = _token_shift(x_full, prev) if s > 1 else prev
    xw, xk, xv, xr, xg = _mix_streams(x_full, xx, tm)

    wr = ctx.weight_gather(tm["wr"], 0)
    wk = ctx.weight_gather(tm["wk"], 0)
    wv = ctx.weight_gather(tm["wv"], 0)
    wg = ctx.weight_gather(tm["wg"], 0)
    r = _heads(xr @ wr, hd)                                # (B,S,Hl,hd)
    k = _heads(xk @ wk, hd)
    v = _heads(xv @ wv, hd)
    g = F.silu(xg @ wg)

    w_lin = tm["w0"].float() + \
        torch.tanh(xw @ tm["wa"]).float() @ tm["wb"].float()
    logw = -torch.exp(torch.clamp(w_lin, -20.0, 10.0))     # log decay < 0
    logw = _heads(logw, hd)
    u = tm["u"].reshape(h_loc, hd)

    s0 = state["s"] if state is not None else torch.zeros(
        (b, h_loc, hd, hd), dtype=torch.float32, device=x_full.device)
    if s == 1:
        # decode: the direct single-step recurrence
        rf, kf, vf = (t[:, 0].float() for t in (r, k, v))
        lwf = logw[:, 0].float()
        kv = torch.einsum("bhc,bhv->bhcv", kf, vf)
        o = torch.einsum("bhc,bhcv->bhv",
                         rf, s0 + u.float()[None, :, :, None] * kv)
        s_new = torch.exp(lwf)[..., None] * s0 + kv
        o = o[:, None].reshape(b, 1, h_loc, hd).to(COMPUTE_DTYPE)
    else:
        o, s_new = _chunk_recurrence(r, k, v, logw, u, s0, chunk)
    o = _group_norm(o, tm["ln_scale"], tm["ln_bias"])
    o = (o.reshape(b, s, h_loc * hd) * g).to(COMPUTE_DTYPE)
    wo = ctx.weight_gather(tm["wo"], 1)
    out = o @ wo                                           # tp-partial
    return out, {"shift": x_full[:, -1:], "s": s_new}


def channel_mix_apply(x_full, p, cfg, plan, ctx, *, state=None):
    """x_full (B, S, D) -> (tp-partial out (B, S, D), new_state {shift})."""
    b, s, d = x_full.shape
    cm = p["cm"]
    prev = state["shift"].to(x_full.dtype) if state is not None else \
        torch.zeros((b, 1, d), dtype=x_full.dtype, device=x_full.device)
    xx = _token_shift(x_full, prev) if s > 1 else prev
    xk = x_full + (xx - x_full) * cm["mu_k"].to(x_full.dtype)
    xr = x_full + (xx - x_full) * cm["mu_r"].to(x_full.dtype)
    wk = ctx.weight_gather(cm["wk"], 0)
    wv = ctx.weight_gather(cm["wv"], 1)
    wr = ctx.weight_gather(cm["wr"], 0)
    k = torch.square(F.relu(xk @ wk))
    r = torch.sigmoid(xr @ wr)                             # full D (replicated W)
    out = r * (k @ wv)                                     # gate distributes over psum
    return out, {"shift": x_full[:, -1:]}
