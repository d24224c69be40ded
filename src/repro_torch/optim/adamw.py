"""AdamW with f32 master weights and f32 moments — the JAX package's
``repro/optim/adamw.py`` on one process.

State: f32 master weights and both moments, one tensor per parameter, and
the step count.  The update keeps the JAX package's order: global-norm
clip scale, moments, bias-corrected step, decoupled weight decay on the
master weights, then the bf16 parameters cast from the masters.  Unlike
the JAX package, whose arrays are immutable, the update writes the
masters, the moments and the bf16 parameters IN PLACE, so a step
allocates no second copy of the optimizer state.

Every rank of the mesh holds its shards of the parameters and of the
state (ZeRO-1: the state is sharded as the parameters are).
``finalize_grads`` sums the grads of parameters that are replicated over
an axis but used divergently (norm scales on the sequence-sharded
residual and replicated kv heads over the TP group; every parameter with
no ``fsdp_dim`` over the fsdp groups, whose ranks saw other rows of the
batch; every parameter over the seq group, whose ranks saw other
positions): the JAX package's ``replicated_grad_axes``.  The fsdp-sharded
grads arrive summed already: they are the output of the weight gather's
backward, the ``grad_rs`` reduce-scatter.  ``global_grad_norm`` sums the
squares of each sharding class over the groups it is sharded on and
counts the replicated ones once, as the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import collectives as cc
from repro_torch.core.parallel import PIPE_AXIS, SP_AXIS
from repro_torch.models.layers import tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr_max: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree) -> list:
    """Leaves of nested dicts / lists in the JAX package's pytree order
    (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def schedule(step: int, oc: OptConfig) -> float:
    """Linear warmup -> cosine decay (paper: 3e-4 -> 3e-5), in f32 as the
    JAX package computes it."""
    f = np.float32
    s = f(step)
    if s < oc.warmup_steps:
        return float(f(f(oc.lr_max) * s) / f(max(oc.warmup_steps, 1)))
    t = np.clip((s - f(oc.warmup_steps))
                / f(max(oc.total_steps - oc.warmup_steps, 1)), f(0), f(1))
    cos = f(oc.lr_min) + f(0.5 * (oc.lr_max - oc.lr_min)) * \
        (f(1) + np.cos(f(math.pi) * t))
    return float(cos)


def init_opt_state(params) -> dict:
    """f32 master copies, zero moments, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"master": tree_map(lambda p: p.detach().float().clone(), params),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


def abstract_opt_state(params) -> dict:
    """The shapes and dtypes of :func:`init_opt_state`'s state, allocating
    nothing: an f32 ``meta`` tensor for ``master``, ``mu`` and ``nu`` per
    leaf of ``params`` (tensors, ``meta`` ones included), and the step,
    which the port keeps as a host int (the JAX package's
    ``abstract_opt_state``, whose step is an int32 scalar on the
    device)."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"master": tree_map(f32, params), "mu": tree_map(f32, params),
            "nu": tree_map(f32, params), "step": 0}


def _axis_groups(model, group, fsdp_groups, sp_group=None) -> dict:
    """Mesh axis name -> what the collectives move over along it (the
    model's fsdp axes, one group each; the seq axis on the seq mesh)."""
    fsdp = tuple(fsdp_groups) or (None,) * len(model.fsdp_axes)
    out = {model.tp_axis: group,
           **dict(zip(model.fsdp_axes, fsdp, strict=True))}
    if getattr(model, "sp_axis", None) is not None:
        out[SP_AXIS] = sp_group
    return out


def finalize_grads(grads, model, group=None, fsdp_groups=(), pipe_group=None,
                   sp_group=None):
    """Sum the grads of replicated-but-divergently-used parameters over the
    mesh axes they are replicated on (``model.replicated_grad_axes``):
    over the TP ``group`` and the ``fsdp_groups`` (one per axis of
    ``model.fsdp_axes``), over the seq group ``sp_group`` (every grad, on
    the seq mesh), and, when ``pipe_group`` moves, every grad that is not
    a layer stack's over the pipe group as well (the JAX package's
    ``_finalize_pipe_grads``).  Per-rank autograd covers only this rank's
    use of them.

    The JAX package sums each such leaf with one ``psum`` over its tuple of
    axes, on the bf16 grads: XLA adds the peers in f32 and rounds the sum
    once to bf16.  So do these sums: one f32 ``all_reduce`` per group of
    the concatenated grads that need it, then each summed grad rounded
    once to its own dtype.  The f32 sum of a few bf16 peers is exact
    unless their magnitudes lie more than ~16 binades apart, so the result
    is the reference's bit for bit, and within one bf16 ulp at worst."""
    by_axis = _axis_groups(model, group, fsdp_groups, sp_group)
    flat, specs = list(leaves(grads)), leaves(model.specs())
    axes = [model.replicated_grad_axes(s) for s in specs]
    if cc.moves(pipe_group):
        outside = leaves({k: tree_map(lambda _, k=k: k != "segments", v)
                          for k, v in grads.items()})
        axes = [a + (PIPE_AXIS,) if o else a for a, o in zip(axes, outside)]
        by_axis[PIPE_AXIS] = pipe_group
    dtypes, summed = [g.dtype for g in flat], set()
    for axis, g in by_axis.items():
        if not cc.moves(g):
            continue
        rep = [i for i, a in enumerate(axes) if axis in a]
        if not rep:
            continue
        buf = cc.psum_exact(torch.cat([flat[i].float().reshape(-1)
                                       for i in rep]), g)
        off = 0
        for i in rep:
            n = flat[i].numel()
            flat[i] = buf[off:off + n].reshape(flat[i].shape)
            off += n
        summed.update(rep)
    for i in summed:
        flat[i] = flat[i].to(dtypes[i])
    it = iter(flat)
    return tree_map(lambda _: next(it), grads)


def global_grad_norm(grads, model, group=None, fsdp_groups=()) -> torch.Tensor:
    """Global L2 norm (f32), summed per sharding class of the spec in the
    JAX package's order: each class's sum of squares is summed over the
    groups it is sharded on (the fsdp groups for an ``fsdp_dim``, the TP
    ``group`` for a ``tp_dim``), the replicated class is counted once."""
    by_axis = _axis_groups(model, group, fsdp_groups)
    terms: dict = {}
    for g, s in zip(leaves(grads), leaves(model.specs())):
        axes = (model.fsdp_axes if s.fsdp_dim is not None else ()) + \
            ((model.tp_axis,) if s.tp_dim is not None else ())
        terms.setdefault(axes, []).append(torch.sum(g.float() ** 2))
    keys = list(terms)
    totals = torch.stack([sum(terms[k]) for k in keys])
    for axis, g in by_axis.items():
        mask = torch.tensor([axis in k for k in keys], device=totals.device)
        if cc.moves(g) and bool(mask.any()):
            summed = cc.psum_exact(torch.where(mask, totals, 0.0), g)
            totals = torch.where(mask, summed, totals)
    return torch.sqrt(totals.sum())


@torch.no_grad()
def adamw_update(params, grads, opt_state, oc: OptConfig, model,
                 group=None, fsdp_groups=()) -> dict:
    """One AdamW step from finalized grads, in place on ``params`` (bf16),
    ``opt_state['master' | 'mu' | 'nu']`` and the step count; ``group`` and
    ``fsdp_groups`` are the TP and fsdp groups the grad norm sums over.
    Returns the metrics ``{"grad_norm": tensor, "lr": float}``."""
    step = opt_state["step"] + 1
    lr = schedule(step, oc)
    gnorm = global_grad_norm(grads, model, group, fsdp_groups)
    scale = torch.clamp(oc.clip_norm / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    b1, b2 = oc.b1, oc.b2
    f = np.float32
    bc1 = float(f(1) - f(b1) ** f(step))
    bc2 = float(f(1) - f(b2) ** f(step))
    for p, g, m, mu, nu in zip(leaves(params), leaves(grads),
                               leaves(opt_state["master"]),
                               leaves(opt_state["mu"]),
                               leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + oc.eps)
        m.sub_(lr * (update + oc.weight_decay * m))
        p.copy_(m)
    opt_state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
