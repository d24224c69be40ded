"""Serving: single-token decode step with a KV cache.

One new token per sequence against a cache of ``max_len`` positions.  TP
communication cannot use sequence parallelism here (seq == 1), so the
residual stream is replicated and every block output goes through the
compressed two-shot AllReduce ``ctx.tp_g`` — the paper's primary
configuration: a token crosses ``n_layers * 2 + 1`` hops (``* 3 + 1`` for
the encoder-decoder, whose cross-attention is a third sub-block).

Cache layout (one dict per layer segment, layer-major; local shapes):
  attention : k, v (L, B, S_cache, kv_local, hd) in bf16
  hybrid    : + conv (L, B, 2, di_local) in bf16, h (L, B, di_local, N) f32
  rwkv      : shift_tm, shift_cm (L, B, 1, D) in bf16,
              s (L, B, H_local, hd, hd) f32, and no k / v
  encdec    : + the cross-attention's xk, xv (L, B, S_enc, kv_local, hd)
              in bf16, S_enc = S_cache (the JAX package's stub length)
SWA segments keep a ring buffer of width ``window`` instead of S_cache.
The decode step writes this cache IN PLACE: the new k/v at the token's
position, and the recurrent state leaves (:data:`STATE_LEAVES`) over
their old values.  The decode step reads ``xk`` / ``xv`` and never
writes them.  The JAX package has no code that fills them either (its
engine prefills token by token through this step), so a served whisper
attends to the zero cache, and its cross-attention adds exactly 0 while
its hops still run; the port mirrors that.  A caller may put an encoder's
keys and values there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.parallel import iter_layer_spans
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (COMPUTE_DTYPE, apply_norm,
                                       distributed_argmax, lm_head_logits,
                                       tree_map)
from repro_torch.models.transformer import (check_family, embed_partial,
                                            gated_sum, head_table,
                                            layer_segments, mlp_apply)

#: cache leaves that a decode step overwrites with the recurrence's new
#: state (the k / v leaves it writes at one position only)
STATE_LEAVES = ("shift_tm", "shift_cm", "s", "conv", "h")


def _seg_cache_len(cfg, kind: str, max_len: int) -> int:
    if kind == "swa" and cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


def cache_shapes(model, global_batch: int, max_len: int) -> list:
    """Per-segment ``{name: (shape, dtype)}`` of the decode cache."""
    cfg, plan = model.cfg, model.plan
    check_family(cfg)
    b, hd = global_batch, cfg.hd
    kv = plan.kv_pad if plan.kv_mode == "sharded" else cfg.n_kv_heads
    kv_local = kv // plan.tp if plan.kv_mode == "sharded" else kv
    segs = []
    for seg in layer_segments(cfg):
        n = seg.count
        if cfg.family == "rwkv":
            shift = ((n, b, 1, cfg.d_model), COMPUTE_DTYPE)
            segs.append({"shift_tm": shift, "shift_cm": shift,
                         "s": ((n, b, plan.q_local, hd, hd), torch.float32)})
            continue
        sc = _seg_cache_len(cfg, seg.kind, max_len)
        shape = (n, b, sc, kv_local, hd)
        entry = {"k": (shape, COMPUTE_DTYPE), "v": (shape, COMPUTE_DTYPE)}
        if cfg.family == "hybrid":
            di_local = cfg.d_model * cfg.ssm.expand // plan.tp
            entry["conv"] = ((n, b, 2, di_local), COMPUTE_DTYPE)
            entry["h"] = ((n, b, di_local, cfg.ssm.d_state), torch.float32)
        if cfg.family == "encdec":
            # the encoder's length is the cache's (the reference's stub)
            xshape = (n, b, max_len, kv_local, hd)
            entry["xk"] = (xshape, COMPUTE_DTYPE)
            entry["xv"] = (xshape, COMPUTE_DTYPE)
        segs.append(entry)
    return segs


def init_cache(model, global_batch: int, max_len: int) -> list:
    return [{k: torch.zeros(shape, dtype=dt, device=model.device)
             for k, (shape, dt) in seg.items()}
            for seg in cache_shapes(model, global_batch, max_len)]


def _no_window(cfg):
    return dataclasses.replace(cfg, window=None)


def _decode_block(x, lp, cache_l, cfg, plan, ctx, *, kind, pos):
    """x (B,1,D) replicated over tp; writes the layer's cache in place."""
    if cfg.family == "rwkv":
        h = ctx.tp_f(apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps))
        out, st = rwkv_mod.time_mix_apply(
            h, lp, cfg, plan, ctx,
            state={"shift": cache_l["shift_tm"], "s": cache_l["s"]})
        cache_l["shift_tm"].copy_(st["shift"])
        cache_l["s"].copy_(st["s"])
        x = x + ctx.tp_g(out)
        h = ctx.tp_f(apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps))
        out, st = rwkv_mod.channel_mix_apply(
            h, lp, cfg, plan, ctx, state={"shift": cache_l["shift_cm"]})
        cache_l["shift_cm"].copy_(st["shift"])
        return x + ctx.tp_g(out)
    h = ctx.tp_f(apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps))
    # attention_decode switches ring-buffer vs full-cache semantics on
    # cfg.window
    cfg_dec = cfg if kind == "swa" and cfg.window is not None \
        else _no_window(cfg)
    partial = attn_mod.attention_decode(h, lp["attn"], cfg_dec, plan, ctx,
                                        cache_l, pos)
    if cfg.family == "hybrid":
        ssm_out, st = ssm_mod.ssm_apply(
            h, lp["ssm"], cfg, plan, ctx,
            state={"conv": cache_l["conv"], "h": cache_l["h"]})
        cache_l["conv"].copy_(st["conv"])
        cache_l["h"].copy_(st["h"])
        partial = gated_sum(partial, ssm_out, lp["branch_gate"])
    x = x + ctx.tp_g(partial)
    if cfg.family == "encdec":
        h = ctx.tp_f(apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps))
        x = x + ctx.tp_g(_cross_decode(h, lp["xattn"], cache_l, cfg, plan,
                                       ctx))
    h = ctx.tp_f(apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps))
    if cfg.family == "moe":
        # the balance loss is a training term: decode drops it
        partial, _ = moe_mod.moe_apply(h, lp["moe"], cfg, plan, ctx)
    else:
        partial = mlp_apply(h, lp["mlp"], cfg.mlp, ctx)
    out = ctx.tp_g(partial)
    if cfg.mlp == "gelu":
        out = out + lp["mlp"]["b2"].to(out.dtype)
    return x + out


def _cross_decode(h, p, cache_l, cfg, plan, ctx):
    """Cross-attention of the new token (B, 1, D) against the encoder's
    cached keys and values ``xk`` / ``xv``: every position, no mask, an
    f32 softmax, the head mask, then ``wo`` — the JAX package's."""
    b = h.shape[0]
    q = attn_mod.q_project(h, p, cfg, plan, ctx, None)          # (B,1,H,hd)
    ke = attn_mod._expand_kv(cache_l["xk"], plan, ctx, cfg)
    ve = attn_mod._expand_kv(cache_l["xv"], plan, ctx, cfg)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float() * (1.0 / np.sqrt(
        cfg.hd)), ke.float())
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, ve.float()).to(COMPUTE_DTYPE)
    out = out * attn_mod.head_mask(plan, ctx, cfg.n_heads, h.device)[
        None, None, :, None]
    wo = ctx.weight_gather(p["wo"], 1)
    return out.reshape(b, 1, -1) @ wo


def _decode_positional(x, params, cfg, ctx, pos):
    """Positional term at decode position(s) ``pos`` (int or (B,))."""
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    if cfg.pos == "learned":
        table = ctx.weight_gather(params["pos_embed"], 0)
        pe = table[pos][:, None] if per_slot else table[int(pos)][None, None]
    else:
        d = cfg.d_model
        div = torch.exp(torch.arange(0, d, 2, device=x.device) / d
                        * -np.log(10000.0)).float()
        p = pos.float() if per_slot else torch.tensor(float(pos),
                                                      device=x.device)
        ang = p[..., None] * div
        pe = torch.zeros(ang.shape[:-1] + (d,), device=x.device)
        pe[..., 0::2] = torch.sin(ang)
        pe[..., 1::2] = torch.cos(ang)
        pe = pe[:, None] if per_slot else pe[None, None]
    return x + pe.to(x.dtype)


@torch.no_grad()
def decode_forward(params, token, cache, pos, model, ctx,
                   return_logits=False):
    """token (B,1) -> next_token (B,1) int32[, logits (B,1,V/tp) f32]: the
    greedy token of the vocabulary, never of its padding (the logits keep
    the padded columns, as the JAX package's).

    ``pos`` is an int shared by the batch or a (B,) tensor of per-slot
    positions (continuous batching — serve/engine.py).  ``cache`` (from
    :func:`init_cache`) is updated in place."""
    cfg, plan = model.cfg, model.plan
    check_family(cfg)
    x = ctx.tp_g(embed_partial(token, params["embed"]["table"], ctx))
    if cfg.pos in ("learned", "sinusoid"):
        x = _decode_positional(x, params, cfg, ctx, pos)

    segments = layer_segments(cfg)
    n_total = max(s.start + s.count for s in segments)
    for seg, sp_, cache_seg in zip(segments, params["segments"], cache):
        off = 0
        for span_n, span_ctx, sp_span in iter_layer_spans(
                ctx, seg.start, seg.count, n_total, sp_):
            for i in range(span_n):
                lp = tree_map(lambda a, i=i: a[i], sp_span)
                cl = {k: v[off + i] for k, v in cache_seg.items()}
                x = _decode_block(x, lp, cl, cfg, plan, span_ctx,
                                  kind=seg.kind, pos=pos)
            off += span_n

    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = lm_head_logits(x, head_table(params, cfg), ctx)
    nxt = distributed_argmax(logits, ctx, cfg.vocab_size).to(torch.int32)
    return (nxt, logits) if return_logits else nxt
