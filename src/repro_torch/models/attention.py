"""TP-sharded GQA attention with head padding / KV replication: the
training path (full sequence, chunked causal softmax) and the decode path
(single new token against a KV cache).

Head layout as in the JAX package: q heads padded to a multiple of tp; kv
heads group-padded and sharded alongside q when n_kv >= tp, else stored
replicated and each rank selects the kv head(s) its local q heads map to.
Dead (padding) q heads are masked out of the output.

Under an active seq group (``ctx.sp_active``) the training path's
sequence is this rank's shard of it, and attention crosses the seq group
(:func:`sp_attention`): DeepSpeed-Ulysses (one all-to-all of q, k and v
from sequence-sharded to head-sharded, the monolithic core on the whole
sequence, the inverse all-to-all back) or ring attention (each peer's KV
block arrives by one permute and is folded into an online softmax).
Every hop goes through the plan's ``sp`` codec, as in the JAX package.
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


# --------------------------------------------------------------------------
# sequence parallelism over the seq group (Ulysses all-to-all / ring)
# --------------------------------------------------------------------------

def ulysses_attention(q, k, v, ctx, *, causal, window):
    """DeepSpeed-Ulysses attention over the seq group.

    q, k, v arrive sequence-sharded ``(B, S/sp, H, hd)``, rope applied at
    the global positions.  ONE compressed all-to-all — q, k and v joined
    along the feature dim into one wire buffer — splits the heads and
    joins the sequence (the transposed ``all_to_all_c`` layout), so the
    monolithic :func:`attention_core` runs on the whole sequence with
    ``H/sp`` heads; the inverse hop brings the output back.  Both hops
    take the plan's ``sp`` codec, and each one's backward is the other
    hop (straight-through cotangent compression)."""
    sp = ctx.sp_size()
    if sp == 1:
        return attention_core(q, k, v, causal=causal, window=window)
    h = q.shape[2]
    if h % sp:
        raise ValueError(
            f"Ulysses attention: local head count {h} not divisible by "
            f"the seq group of size {sp}")
    qkv = torch.cat([q, k, v], dim=-1)              # (B, S/sp, H, 3 hd)
    qkv = ctx.sp_all_to_all(qkv, 2, 1)              # (B, S, H/sp, 3 hd)
    qf, kf, vf = torch.chunk(qkv, 3, dim=-1)
    out = attention_core(qf, kf, vf, causal=causal, window=window)
    return ctx.sp_all_to_all(out, 1, 2)             # (B, S/sp, H, hd)


def _block_bias(q_pos, kv_pos, *, causal, window):
    """Additive (Sq, Sk) f32 mask between global q and kv positions."""
    bad = torch.zeros((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        bad |= kv_pos[None, :] > q_pos[:, None]
    if window is not None:
        bad |= kv_pos[None, :] <= q_pos[:, None] - window
    return torch.where(bad, NEG_INF, 0.0).to(torch.float32)


def _block_partial(qf, kb, vb, bias):
    """Online-softmax partial of pre-scaled f32 q ``(B, H, Sq, hd)``
    against one KV block ``(B, H, Sk, hd)``: ``(acc, m, l)``.  A fully
    masked block (a future block under causal masking) gives exactly
    ``(0, NEG_INF, 0)``, which merges as a no-op."""
    s_ = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) + bias[None, None]
    m = s_.amax(dim=-1)
    finite = m > NEG_INF * 0.5
    msafe = torch.where(finite, m, 0.0)
    p_ = torch.where(finite[..., None], torch.exp(s_ - msafe[..., None]),
                     0.0)
    acc = torch.einsum("bhqk,bhkd->bhqd", p_, vb.float())
    return acc, torch.where(finite, m, NEG_INF), p_.sum(dim=-1)


def _merge_partial(a, b):
    """Fold two online-softmax partials (rescale and add; associative)."""
    acc1, m1, l1 = a
    acc2, m2, l2 = b
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    # both empty: exp(0) = 1, but acc and l are exactly 0: still a no-op
    return (acc1 * c1[..., None] + acc2 * c2[..., None], m,
            l1 * c1 + l2 * c2)


def ring_attention(q, k, v, ctx, *, causal, window):
    """Blockwise ring attention over the seq group.

    q stays sequence-local ``(B, S/sp, H, hd)``; the KV block of the peer
    ``t`` ranks behind arrives by ONE compressed permute (k and v joined
    along the feature dim into one wire buffer, sent straight to the peer
    ``t`` ahead) and is folded into an online-softmax accumulator under
    global-position masks.  The hops are emitted by
    ``core/overlap.run_ring`` under the ``sp`` codec's ``schedule``
    (pipelined or serial, bit-identical), as the JAX package does.  The
    output matches the monolithic core within the re-association of the
    online softmax (blocks fold in arrival order, which differs per
    rank)."""
    sp = ctx.sp_size()
    if sp == 1:
        return attention_core(q, k, v, causal=causal, window=window)
    from repro_torch.core import overlap
    b, s_loc, h, hd = q.shape
    i = ctx.sp_index()
    dev = q.device
    q_pos = i * s_loc + torch.arange(s_loc, device=dev)
    qf = q.transpose(1, 2).float() / np.sqrt(hd)
    kv = torch.cat([k, v], dim=-1)                 # one wire buffer a hop

    def partial_for(block, src):
        kb, vb = torch.chunk(block, 2, dim=-1)
        kv_pos = src * s_loc + torch.arange(s_loc, device=dev)
        bias = _block_bias(q_pos, kv_pos, causal=causal, window=window)
        return _block_partial(qf, kb.transpose(1, 2), vb.transpose(1, 2),
                              bias)

    def transfer(t):
        perm = tuple((r, (r + t) % sp) for r in range(sp))
        return lambda blk: ([ctx.sp_permute(blk, perm)], ())

    def decode(t):
        return lambda moved: partial_for(moved[0][0], (i - t) % sp)

    parts = overlap.run_ring(
        [kv] * (sp - 1), encode=lambda blk: blk,
        transfer=[transfer(t) for t in range(1, sp)],
        decode=[decode(t) for t in range(1, sp)],
        schedule=overlap.ring_schedule(ctx.plan.sp))
    state = partial_for(kv, i)                     # this rank's own block
    for part in parts:
        state = _merge_partial(state, part)
    acc, _, l = state
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(COMPUTE_DTYPE)


def sp_attention(q, k, v, ctx, *, causal, window):
    """The seq group's attention flavour (``ctx.sp_mode``)."""
    if ctx.sp_mode == "ring":
        return ring_attention(q, k, v, ctx, causal=causal, window=window)
    if ctx.sp_mode != "ulysses":
        raise ValueError(f"unknown sp_mode {ctx.sp_mode!r}")
    return ulysses_attention(q, k, v, ctx, causal=causal, window=window)


def attention_apply(x_full, p, cfg, plan, ctx, *, causal=True, window=None,
                    positions=None, kv_source=None):
    """x_full (B, S, D) -> tp-partial output (B, S, D) (the caller
    reduces).  ``positions`` defaults to 0..S-1, offset by the seq rank's
    shard under an active seq group, where S is the shard's length and
    attention crosses the group (:func:`sp_attention`).  ``kv_source``
    (B, S_enc, D), the encoder's output, makes this cross-attention: keys
    and values are projected from it with this layer's wk / wv and no
    rope; under sequence parallelism it is refused as the JAX package
    refuses it."""
    b, s, _ = x_full.shape
    if kv_source is not None and ctx.sp_active:
        raise NotImplementedError(
            "cross-attention under an active sp axis is not supported")
    if positions is None:
        positions = ctx.sp_index() * s + torch.arange(s,
                                                      device=x_full.device)
    q = q_project(x_full, p, cfg, plan, ctx, positions)
    if kv_source is not None:
        k, v = kv_project(kv_source, p, cfg, plan, ctx, None)
    else:
        k, v = kv_project(x_full, p, cfg, plan, ctx, positions)
    k = _expand_kv(k, plan, ctx, cfg)
    v = _expand_kv(v, plan, ctx, cfg)
    if ctx.sp_active:
        out = sp_attention(q, k, v, ctx, causal=causal, window=window)
    else:
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
