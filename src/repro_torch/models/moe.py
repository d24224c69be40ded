"""Mixture-of-Experts layer (grok-1, llama4-maverick): the JAX package's
``repro/models/moe.py`` in PyTorch.

Megatron-style tensor-parallel MoE: every expert's FFN is cut over the
model axis exactly like the dense MLP (so the TP communication pattern,
and TACO's compression sites, are the dense block's); the expert weights'
d dim is fsdp-sharded for storage and gathered per layer.

Dispatch is sort-based with a static per-expert capacity
(``capacity_factor`` over the mean load): tokens are routed top-k, sorted
by expert, packed into an (E, C + 1, D) buffer (a token past an expert's
capacity lands in the scratch slot C, whose output is dropped), run
through batched expert products, and combined with the renormalized
router weights.

Routing must be the JAX package's token for token, so the router keeps its
numerics.  The logits are an f32 product of the bf16 operands: the JAX
package writes ``(x @ w_router).astype(float32)``, a bf16 product cast up,
but under ``jax.jit`` XLA drops that bf16 round trip (its default
``xla_allow_excess_precision``) and the dot runs in f32 with f32 output;
the jitted package's logits are not bf16 values, and rounding the port's to
bf16 would route differently (``tests/test_torch_moe.py`` holds both
facts).  Top-k takes the higher probability first and, on a tie, the lower
expert index (``jax.lax.top_k``'s order); the sort by expert is stable.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import COMPUTE_DTYPE


def moe_specs(pb, name: str, cfg, plan):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    pb.add(f"{name}.router", (d, e), init="normal", scale=0.01)
    pb.add(f"{name}.w1", (e, d, f), fsdp_dim=1, tp_dim=2)
    pb.add(f"{name}.w3", (e, d, f), fsdp_dim=1, tp_dim=2)
    pb.add(f"{name}.w2", (e, f, d), fsdp_dim=2, tp_dim=1)


def _capacity(tokens: int, e: int, k: int, cf: float) -> int:
    c = int(tokens * k * cf / e) + 1
    return max(c, 4)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` of the last dim: the k largest values in
    descending order, a tie broken towards the lower index.  ``probs``
    are f32 and not negative (softmax outputs), so their bit patterns
    order as their values; each key appends the reversed index below
    them, which makes every key of a row distinct and the order total —
    ``torch.topk``'s order among equal values, unspecified on the card,
    never comes into play."""
    e = probs.shape[-1]
    rev = torch.arange(e - 1, -1, -1, device=probs.device)
    key = probs.detach().contiguous().view(torch.int32).long() * e + rev
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(probs, -1, idx), idx


def stable_argsort(v: torch.Tensor) -> torch.Tensor:
    """``argsort(v, stable=True)`` of a 1-d integer tensor: equal values
    keep their order.  Each key is the value with the position below it,
    so all keys differ and any sort gives the stable order."""
    n = v.shape[0]
    return torch.argsort(v.long() * n + torch.arange(n, device=v.device))


def route(xg, wr, e: int, k: int):
    """Router of one group: ``(probs (G, E) f32, top_p (G, k) f32
    renormalized, top_e (G, k) int64, aux)``; aux is the Switch-style
    load-balancing loss ``E * sum(density * mean_prob)``, the density
    taken from each token's first choice."""
    logits = xg.float() @ wr.float()                 # as the jitted reference
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    density = F.one_hot(top_e[:, 0], e).float().mean(0)
    aux = e * torch.sum(density * probs.mean(0))
    return probs, top_p, top_e, aux


def dispatch(top_e, group: int, e: int, k: int, cap: int):
    """Sort-based dispatch of one group's ``(G, k)`` choices: ``(se,
    slot, keep, order)`` — the expert, the slot in its buffer (``cap`` is
    the scratch slot of a token past the capacity) and whether the choice
    is kept, for each choice in the stable order by expert, and that
    order over the token-major flat choices."""
    flat_e = top_e.reshape(-1)                       # (G k,)
    order = stable_argsort(flat_e)
    se = flat_e[order]
    seg_start = torch.searchsorted(se, torch.arange(e, device=se.device))
    pos = torch.arange(group * k, device=se.device) - seg_start[se]
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    return se, slot, keep, order


def moe_apply(x_full, p, cfg, plan, ctx, *, group: int = 4096):
    """x_full (B, S, D) -> (tp-partial (B, S, D), aux scalar f32).

    The router runs replicated across the TP group (identical inputs after
    the entry all-gather); the expert FFNs give tp-partial outputs that
    the caller reduces through the block's exit hop, the same one
    compressed collective as the dense MLP's.  More tokens than ``group``
    (and a multiple of it) run ``group`` at a time, each group recomputed
    in the backward (``torch.utils.checkpoint``, the JAX package's
    ``lax.map(jax.checkpoint(one_group))``); aux is then the groups'
    mean."""
    b, s, d = x_full.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    tokens = x_full.reshape(b * s, d)
    t = tokens.shape[0]
    group = min(group, t)
    if t % group:
        group = t
    n_groups = t // group
    cap = _capacity(group, e, k, cfg.moe.capacity_factor)

    w1 = ctx.weight_gather(p["w1"], 1)     # (E, D, F/tp)
    w3 = ctx.weight_gather(p["w3"], 1)
    w2 = ctx.weight_gather(p["w2"], 2)     # (E, F/tp, D)
    wr = p["router"]

    def one_group(xg):
        _, top_p, top_e, aux = route(xg, wr, e, k)
        se, slot, keep, order = dispatch(top_e, group, e, k, cap)
        st = torch.div(order, k, rounding_mode="floor")   # token of a choice
        sp_ = top_p.reshape(-1)[order]

        buf = torch.zeros((e, cap + 1, d), dtype=COMPUTE_DTYPE,
                          device=xg.device)
        # several dropped choices may write the scratch slot; its output is
        # masked below, so which one lands there does not matter
        buf = buf.index_put((se, slot), xg[st].to(COMPUTE_DTYPE))
        h = torch.bmm(buf, w1)
        g = torch.bmm(buf, w3)
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(h) if cfg.mlp == "swiglu" \
            else F.gelu(h, approximate="tanh")
        out_buf = torch.bmm(act * g, w2)                 # (E, C + 1, D)

        gathered = out_buf[se, slot]                     # (G k, D)
        gathered = torch.where(keep[:, None], gathered,
                               torch.zeros((), dtype=gathered.dtype,
                                           device=gathered.device))
        # a bf16 scatter-add into zeros, as the reference's: with top_k <= 2
        # a row takes at most two addends, 0 + a is exact and a + b rounds
        # once whatever the order, so the card's atomic adds give the
        # reference's bits (no configuration routes more than two)
        combined = torch.zeros((group, d), dtype=COMPUTE_DTYPE,
                               device=xg.device)
        combined = combined.index_add(
            0, st, gathered * sp_[:, None].to(COMPUTE_DTYPE))
        return combined, aux

    if n_groups == 1:
        out, aux = one_group(tokens)
    else:
        outs, auxs = [], []
        for xg in tokens.reshape(n_groups, group, d).unbind(0):
            o, a = checkpoint(one_group, xg, use_reentrant=False)
            outs.append(o)
            auxs.append(a)
        out, aux = torch.cat(outs), torch.stack(auxs).mean()
    return out.reshape(b, s, d), aux
