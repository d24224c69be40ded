"""The plain training steps that the check holds the program to: the
loss of ``reference/model.py``, its gradient, and AdamW with f32 master
weights (clip by the global norm, bias-corrected moments, decoupled
weight decay; linear warmup then cosine decay), as the traffic file
states them.

:func:`follow` runs the first steps from the benchmark's weights on the
benchmark's batches and returns what the check compares: each step's
loss, each parameter's gradient norm at the first step as AdamW's moment
takes it (after the clip), each parameter's change over the steps, and
three TP hops of the last step (``taco.Tap``).  A parameter is a leaf of
the weight tree, or one layer of a stacked leaf.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import model, taco


def lr_at(step: int, opt: dict) -> float:
    """Learning rate of optimizer step ``step`` (1-based), in f32."""
    f = np.float32
    s, warm = f(step), opt["warmup_steps"]
    if s < warm:
        return float(f(f(opt["lr"]) * s) / f(max(warm, 1)))
    t = np.clip((s - f(warm)) / f(max(opt["total_steps"] - warm, 1)),
                f(0), f(1))
    lo = opt["lr"] * opt["lr_min_ratio"]
    return float(f(lo) + f(0.5 * (opt["lr"] - lo))
                 * (f(1) + np.cos(f(math.pi) * t)))


def named_leaves(tree, prefix=""):
    """(name, tensor) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def per_param(name: str, t: torch.Tensor, fn) -> dict:
    """``fn`` of each parameter of a leaf: each layer of a stacked
    (``segments.``) leaf apart, any other leaf whole."""
    if name.startswith("segments."):
        return {f"{name}[{i}]": fn(t[i]) for i in range(t.shape[0])}
    return {name: fn(t)}


def norms(tree) -> dict:
    """f64 L2 norm of every parameter of a tree."""
    out = {}
    for name, t in named_leaves(tree):
        out.update(per_param(name, t,
                             lambda a: float(a.double().norm())))
    return out


@torch.no_grad()
def adamw(w, grads, state, step: int, opt: dict) -> float:
    """One AdamW step in place on the f32 weights ``w`` and moments;
    returns the global gradient norm."""
    gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
    scale = min(1.0, opt["clip_norm"] / max(float(gnorm), 1e-12))
    b1, b2, lr = opt["b1"], opt["b2"], lr_at(step, opt)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for p, g, m, v in zip(w, grads, state["mu"], state["nu"]):
        g = g * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
    return float(gnorm)


def follow(weights, initial, batches, cfg, codec, opt, prec="f32",
           rows=None, stale=False) -> dict:
    """Train ``len(batches)`` steps from ``weights`` (a tree of f32
    tensors, changed in place) and return ``{"loss": [...], "grad":
    {param: norm}, "change": {param: norm}, "hops": {name: (input,
    output, first)}}``: the grad norms are the first step's clipped
    gradient's, the changes ``weights`` after the last step less
    ``initial(i)``, the i-th leaf as it started, the hops the last
    step's.  Two faults of the check's tests: ``rows`` leaves the rest of
    each batch out; ``stale`` runs every step on the weights as they
    started while AdamW moves ``weights`` (a working copy never refreshed
    from the master weights)."""
    if prec == "f32":
        model.set_exact()
    leaves = [t for _, t in named_leaves(weights)]
    work, run_on = weights, leaves
    if stale:
        run_on = [t.clone() for t in leaves]
        work = like_tree(weights, run_on)
    state = {"mu": [torch.zeros_like(t) for t in leaves],
             "nu": [torch.zeros_like(t) for t in leaves]}
    out = {"loss": []}
    for i, batch in enumerate(batches):
        for t in run_on:
            t.requires_grad_(True)
        last = i == len(batches) - 1
        taco.TAP = taco.Tap() if last else None
        loss = model.loss(work, batch, cfg, codec, prec, rows)
        grads = torch.autograd.grad(loss, run_on, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, run_on)]
        if last:
            out["hops"], taco.TAP = taco.TAP.records(), None
        for t in run_on:
            t.requires_grad_(False)
        out["loss"].append(float(loss.detach()))
        adamw(leaves, grads, state, i + 1, opt)
        if i == 0:
            out["grad"] = first_grad_norms(like_tree(weights, state["mu"]),
                                           opt)
        del grads, loss
    out["change"] = change_norms(weights, initial)
    return out


def first_grad_norms(mu, opt) -> dict:
    """The first step's gradient, as AdamW's first moment ``mu`` (a
    tree) took it after the clip: the norms of ``mu / (1 - b1)``, by
    parameter."""
    return {k: v / (1.0 - opt["b1"]) for k, v in norms(mu).items()}


def change_norms(tree, initial) -> dict:
    """Norm of each parameter's change: leaf i of ``tree`` (f32) less
    ``initial(i)``, one leaf at a time."""
    out = {}
    for i, (name, t) in enumerate(named_leaves(tree)):
        d = t.detach().float() - initial(i).float()
        out.update(per_param(name, d, lambda a: float(a.double().norm())))
        del d
    return out


def like_tree(tree, flat):
    """``flat`` (leaves in :func:`named_leaves` order) in ``tree``'s
    shape."""
    it = iter(flat)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [fill(x) for x in t]
        return next(it)
    return fill(tree)
