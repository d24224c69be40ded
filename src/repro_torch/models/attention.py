"""TP-sharded GQA attention with head padding / KV replication: the
training path (full sequence, chunked causal softmax) and the decode path
(single new token against a KV cache).

Head layout as in the JAX package: q heads padded to a multiple of tp; kv
heads group-padded and sharded alongside q when n_kv >= tp, else stored
replicated and each rank selects the kv head(s) its local q heads map to.
Dead (padding) q heads are masked out of the output.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import COMPUTE_DTYPE, apply_rope

NEG_INF = -1e30


def attn_specs(pb, name: str, cfg, plan):
    d, hd = cfg.d_model, cfg.hd
    pb.add(f"{name}.wq", (d, plan.heads_pad * hd), fsdp_dim=0, tp_dim=1)
    kv_dim = plan.kv_pad * hd
    kv_tp = 1 if plan.kv_mode == "sharded" else None
    pb.add(f"{name}.wk", (d, kv_dim), fsdp_dim=0, tp_dim=kv_tp)
    pb.add(f"{name}.wv", (d, kv_dim), fsdp_dim=0, tp_dim=kv_tp)
    pb.add(f"{name}.wo", (plan.heads_pad * hd, d), fsdp_dim=1, tp_dim=0)
    if cfg.qkv_bias:
        bias_tp = 0 if kv_tp is not None else None
        pb.add(f"{name}.bq", (plan.heads_pad * hd,), tp_dim=0, init="zeros")
        pb.add(f"{name}.bk", (kv_dim,), tp_dim=bias_tp, init="zeros")
        pb.add(f"{name}.bv", (kv_dim,), tp_dim=bias_tp, init="zeros")


def _local_head_ids(plan, ctx, device):
    """Global q-head ids held by this rank."""
    return ctx.tp_rank * plan.q_local + torch.arange(plan.q_local,
                                                     device=device)


def head_mask(plan, ctx, n_heads: int, device=None):
    return (_local_head_ids(plan, ctx, device) < n_heads).to(COMPUTE_DTYPE)


def _expand_kv(k, plan, ctx, cfg):
    """k (B, S, kv_local, hd) -> (B, S, q_local, hd), aligned to the rank's
    local q heads."""
    if plan.kv_mode == "sharded":
        gsz = plan.group_size
        return torch.repeat_interleave(k, gsz, dim=2) if gsz > 1 else k
    gsz = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    ids = _local_head_ids(plan, ctx, k.device)
    kv_ids = torch.clamp(ids // gsz, 0, plan.kv_local - 1)
    return k[:, :, kv_ids]


def q_project(x_full, p, cfg, plan, ctx, positions):
    b, s, _ = x_full.shape
    q = x_full @ ctx.weight_gather(p["wq"], 0)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(b, s, plan.q_local, cfg.hd)
    if cfg.pos == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def kv_project(x_kv, p, cfg, plan, ctx, positions):
    """positions=None skips rope."""
    b, s, _ = x_kv.shape
    k = x_kv @ ctx.weight_gather(p["wk"], 0)
    v = x_kv @ ctx.weight_gather(p["wv"], 0)
    if cfg.qkv_bias:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    k = k.reshape(b, s, -1, cfg.hd)
    v = v.reshape(b, s, -1, cfg.hd)
    if cfg.pos == "rope" and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def qkv_project(x_full, p, cfg, plan, ctx, positions):
    q = q_project(x_full, p, cfg, plan, ctx, positions)
    k, v = kv_project(x_full, p, cfg, plan, ctx, positions)
    return q, k, v


# --------------------------------------------------------------------------
# chunked attention core (training path)
# --------------------------------------------------------------------------

def _softmax_scan(q, k, v, mask_fn, kv_chunk: int):
    """q (B,H,Cq,hd) vs k, v (B,H,Sk,hd) -> (B,H,Cq,hd) f32: online
    softmax over kv chunks in order; ``mask_fn(kv_start, ck)`` gives the
    (Cq, ck) additive mask."""
    b, h, cq, hd = q.shape
    sk = k.shape[2]
    kv_chunk = min(kv_chunk, sk)
    scale = 1.0 / np.sqrt(hd)
    qf = q.float() * scale
    acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
    for j in range(sk // kv_chunk):
        lo = j * kv_chunk
        kc = k[:, :, lo:lo + kv_chunk].float()
        vc = v[:, :, lo:lo + kv_chunk].float()
        s_ = torch.einsum("bhqd,bhkd->bhqk", qf, kc)
        s_ = s_ + mask_fn(lo, kv_chunk)[None, None]
        m_new = torch.maximum(m, s_.amax(dim=-1))
        p_ = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p_, vc)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def attention_core(q, k, v, *, causal: bool, window: int | None,
                   q_chunk: int = 512, kv_chunk: int = 512):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd) head-aligned -> (B,Sq,H,hd) bf16.

    The JAX package's monolithic form: q in chunks of ``q_chunk``, each
    against every kv chunk (masked ones included) with an f32 online
    softmax; a sliding window slices a static (W + Cq)-wide kv span per q
    chunk."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    q_chunk = min(q_chunk, sq)
    if sq % q_chunk:
        q_chunk = sq
    dev = q.device

    def one_q_chunk(qi):
        qc = qt[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        if window is not None:
            w = min(window, sk)
            width = min(w + q_chunk, sk)
            lo = min(max(qi * q_chunk - w + 1, 0), sk - width)
            kc, vc = kt[:, :, lo:lo + width], vt[:, :, lo:lo + width]

            def mask_fn(kv_start, ck):
                kpos = lo + kv_start + torch.arange(ck, device=dev)
                bad = (kpos[None, :] > q_pos[:, None]) | \
                    (kpos[None, :] <= q_pos[:, None] - w)
                return torch.where(bad, NEG_INF, 0.0)

            return _softmax_scan(qc, kc, vc, mask_fn, kv_chunk)

        def mask_fn(kv_start, ck):
            if not causal:
                return torch.zeros((q_chunk, ck), device=dev)
            kpos = kv_start + torch.arange(ck, device=dev)
            return torch.where(kpos[None, :] > q_pos[:, None], NEG_INF, 0.0)

        return _softmax_scan(qc, kt, vt, mask_fn, kv_chunk)

    out = torch.cat([one_q_chunk(i) for i in range(sq // q_chunk)], dim=2)
    return out.transpose(1, 2).to(COMPUTE_DTYPE)


def attention_apply(x_full, p, cfg, plan, ctx, *, causal=True, window=None,
                    positions=None):
    """x_full (B, S, D) -> tp-partial output (B, S, D) (the caller
    reduces).  ``positions`` defaults to 0..S-1."""
    b, s, _ = x_full.shape
    if positions is None:
        positions = torch.arange(s, device=x_full.device)
    q, k, v = qkv_project(x_full, p, cfg, plan, ctx, positions)
    k = _expand_kv(k, plan, ctx, cfg)
    v = _expand_kv(v, plan, ctx, cfg)
    out = attention_core(q, k, v, causal=causal, window=window)
    out = out * head_mask(plan, ctx, cfg.n_heads, x_full.device)[None, None,
                                                                 :, None]
    wo = ctx.weight_gather(p["wo"], 1)
    return out.reshape(b, s, plan.q_local * cfg.hd) @ wo


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------

def attention_decode(x, p, cfg, plan, ctx, cache, pos):
    """x (B, 1, D) full-D; cache dict {k, v}: (B, S_cache, kv_local, hd).
    Returns the tp-partial output (B, 1, D).

    Unlike the JAX package, which returns a rebuilt cache, the new k/v are
    written INTO ``cache`` in place (``index_put`` on the row's slot), so
    a decode step allocates no second cache.  SWA layers use a ring buffer
    of width ``window`` (S_cache == window).

    ``pos`` is an int (every row at the same position) or a (B,) integer
    tensor of per-slot positions (continuous batching); both write the
    same values at the same cache positions."""
    b = x.shape[0]
    hd = cfg.hd
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    if per_slot:
        positions = pos[:, None]
    else:
        positions = torch.full((1,), int(pos), device=x.device,
                               dtype=torch.long)
    q, k_new, v_new = qkv_project(x, p, cfg, plan, ctx, positions)
    s_cache = cache["k"].shape[1]
    slot = positions % s_cache if cfg.window is not None else positions
    rows = torch.arange(b, device=x.device)
    idx = slot[:, 0] if per_slot else slot.expand(b)
    cache["k"][rows, idx] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, idx] = v_new[:, 0].to(cache["v"].dtype)
    ke = _expand_kv(cache["k"], plan, ctx, cfg)
    ve = _expand_kv(cache["v"], plan, ctx, cfg)
    acc_t = torch.float32 if plan.attn_f32 else ke.dtype
    scale = 1.0 / np.sqrt(hd)
    qf = q.to(acc_t) * scale                                    # (B,1,H,hd)
    scores = torch.einsum("bqhd,bshd->bhqs", qf, ke.to(acc_t)).float()
    kv_pos = torch.arange(s_cache, device=x.device)[None, :]    # (1, S)
    pos_c = positions.reshape(-1, 1)                            # (B|1, 1)
    if cfg.window is not None:
        # ring buffer: slot j holds position pos - ((pos - j) mod W),
        # valid iff that position has been written (>= 0)
        valid = torch.remainder(pos_c - kv_pos, s_cache) <= pos_c
    else:
        valid = kv_pos <= pos_c
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(acc_t), ve.to(acc_t))
    out = out.to(COMPUTE_DTYPE)
    out = out * head_mask(plan, ctx, cfg.n_heads, x.device)[None, None, :,
                                                            None]
    wo = ctx.weight_gather(p["wo"], 1)
    return out.reshape(b, 1, plan.q_local * hd) @ wo
