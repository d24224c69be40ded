"""The plain forward and loss of the benchmark's models, in PyTorch f32.

One function of the weights and a batch: the token embedding, each
layer (norm, attention with its heads, the MLP) and the head's
cross-entropy, with every TP hop of the training step's Megatron-SP
layout as a TACO round trip (``reference/taco.py``; none under an
identity codec).  It follows the configuration file's
widths and kinds and imports nothing of the program.

``prec`` names the arithmetic: ``"f32"`` (TF32 off, the reference) or
``"fp8"``, the lower-precision control: both operands of every matrix
product, and every activation and cotangent that a hop carries, rounded
to e4m3 with one scale a tensor.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import taco


def set_exact() -> None:
    """Matrix products in full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _Fp8Product(torch.autograd.Function):
    """``a @ b`` with both operands in e4m3, and the backward's two
    products with the cotangent in e4m3 too, as an FP8 training step
    computes them."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = taco.fp8_round(a.detach()), taco.fp8_round(b.detach())
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = taco.fp8_round(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def mm(a, b, prec: str):
    if prec == "fp8":
        return _Fp8Product.apply(a, b)
    return a @ b


def segments(cfg) -> list[tuple[str, int]]:
    """(kind, layer count) of each run of layers with one attention kind:
    all layers windowed under a window, else all full."""
    return [("swa" if cfg.get("window") else "full", cfg["n_layers"])]


def norm(x, p, cfg):
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + cfg["norm_eps"]) * \
            (1.0 + p["scale"]) + p["bias"]
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + cfg["norm_eps"]) * (1.0 + p["scale"])


def rope(x, theta: float):
    """Rotary positions on (B, S, H, hd), the two halves of each head."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv[None]).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, p, cfg, prec, window):
    b, s, d = h.shape
    hd, nh, nkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    q = mm(h, p["wq"], prec)
    k = mm(h, p["wk"], prec)
    v = mm(h, p["wv"], prec)
    if cfg["qkv_bias"]:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg["pos"] == "rope":
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # (B, H, S, hd)
    scores = mm(q / math.sqrt(hd), k.transpose(-1, -2), prec)
    pos = torch.arange(s, device=h.device)
    bad = pos[None, :] > pos[:, None]
    if window is not None:
        bad = bad | (pos[None, :] <= pos[:, None] - window)
    probs = torch.softmax(scores.masked_fill(bad, float("-inf")), dim=-1)
    out = mm(probs, v, prec).transpose(1, 2).reshape(b, s, nh * hd)
    return mm(out, p["wo"], prec)


def mlp(h, p, cfg, prec):
    if cfg["mlp"] == "gelu":
        return mm(F.gelu(mm(h, p["w1"], prec) + p["b1"], approximate="tanh"),
                  p["w2"], prec)
    act = F.silu if cfg["mlp"] == "swiglu" else \
        (lambda t: F.gelu(t, approximate="tanh"))
    return mm(act(mm(h, p["w1"], prec)) * mm(h, p["w3"], prec), p["w2"],
              prec)


def block(x, lp, cfg, codec, prec, kind):
    h = taco.enter(norm(x, lp["norm1"], cfg), codec, prec)
    out = attention(h, lp["attn"], cfg, prec,
                    cfg["window"] if kind == "swa" else None)
    x = x + taco.leave(out, codec, prec)
    h = taco.enter(norm(x, lp["norm2"], cfg), codec, prec)
    out = taco.leave(mlp(h, lp["mlp"], cfg, prec), codec, prec)
    if cfg["mlp"] == "gelu":
        out = out + lp["mlp"]["b2"]
    return x + out


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _xent(x, table, labels, prec):
    logits = mm(x, table.t(), prec)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), reduction="sum")


def loss(w, batch, cfg, codec, prec="f32", rows=None, chunk=512):
    """Mean next-token cross-entropy of ``batch`` (tokens, labels: (B,
    S)) over the padded vocabulary, each layer and each sequence chunk of
    the head recomputed in the backward.  ``rows`` takes the first rows
    of the batch only (a fault of the check's tests)."""
    tokens, labels = batch["tokens"], batch["labels"]
    if rows is not None:
        tokens, labels = tokens[:rows], labels[:rows]
    s = tokens.shape[1]
    x = taco.leave(w["embed"]["table"][tokens], codec, prec)
    if cfg["pos"] == "learned":
        x = x + w["pos_embed"][:s]
    for (kind, count), seg in zip(segments(cfg), w["segments"]):
        for i in range(count):
            x = checkpoint(block, x, _layer(seg, i), cfg, codec, prec, kind,
                           use_reentrant=False)
    x = taco.enter(norm(x, w["final_norm"], cfg), codec, prec)
    table = w["embed" if cfg["tie_embeddings"] else "head"]["table"]
    total = x.new_zeros(())
    for lo in range(0, s, chunk):
        total = total + checkpoint(_xent, x[:, lo:lo + chunk], table,
                                   labels[:, lo:lo + chunk], prec,
                                   use_reentrant=False)
    return total / labels.numel()
