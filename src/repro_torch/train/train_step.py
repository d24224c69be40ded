"""The training step: loss, backward through the compressed collectives,
AdamW — the JAX package's ``repro/train/train_step.py`` on one rank of the
mesh.

Every TP hop of the forward is a compressed collective whose backward is
its conjugate (``core/collectives.py``), so the backward moves compressed
cotangents through the ``tp_bwd`` codec.  Every weight use is an fsdp
gather whose backward reduce-scatters the weight gradient over the data
axes through the ``grad_rs`` codec (SDP4bit's int4 under
``grad_rs=sdp4bit``).  Each data rank takes its rows of the global batch;
the loss sum and the token count are summed over the dp axes
(:func:`dp_axes`), so every rank holds the global loss, and the summed
loss's backward passes the cotangent through unchanged (``psum_exact``):
each rank's gradient is its own rows' share of the global mean.

A step is two phases (:class:`TrainStep`): ``grads`` runs every hop of
the step — forward, backward and the ``grad_rs`` reduce-scatters — and
writes nothing; ``apply`` is the optimizer update, which writes the
parameters and the optimizer state in place.  The trainer's policy
engine decides whether a step stands (a negotiated wire bound may have
overflowed, ``core/policy.py``) between the two, so a replayed step
starts from untouched state.

:func:`build_eval_step` is the forward alone: the global mean loss over
the dp groups, with no gradient and no update.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.collectives import group_size, psum_exact
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw


def dp_axes(model) -> tuple:
    """Mesh axes the scalar loss and token count are summed over: the fsdp
    data axes (the batch's rows are sharded over them) and, on the seq
    mesh, the seq axis (its sequence is)."""
    sp = getattr(model, "sp_axis", None)
    return tuple(model.fsdp_axes) + ((sp,) if sp is not None else ())


def check_fsdp_axes(model, ctx) -> None:
    """The model's fsdp axes (how its weights are cut) must be the ctx's
    (the groups its collectives run over): the optimizer pairs them one to
    one."""
    if tuple(model.fsdp_axes) != tuple(ctx.fsdp_axes):
        raise ValueError(f"the model is cut over the fsdp axes "
                         f"{model.fsdp_axes}, the ctx's groups are over "
                         f"{ctx.fsdp_axes}")


def check_sp(model, ctx) -> None:
    """The model's seq axis (how its batch is cut, what its grads are
    summed over) must match the ctx's seq group."""
    sp = model.sp if getattr(model, "sp_axis", None) is not None else None
    want = ctx.sp_size() if ctx.sp_active else None
    if sp != want:
        raise ValueError(f"the model is cut over a seq axis of {sp} ranks, "
                         f"the ctx's seq group has {want}")


class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    in two phases: ``grads(params, batch) -> (grads, loss)`` runs every hop
    and writes nothing (the parameters' ``.grad`` are cleared again);
    ``apply(params, opt_state, grads, loss)`` updates the parameters and
    ``opt_state`` in place.  metrics: ``loss`` and ``grad_norm`` (0-d f32
    tensors on the device) and ``lr`` (float)."""

    def __init__(self, grads, apply):
        self.grads, self.apply = grads, apply

    def __call__(self, params, opt_state, batch):
        return self.apply(params, opt_state, *self.grads(params, batch))


def backward_grads(params, loss, model, ctx, pipe_group=None):
    """``loss.backward()`` and the finalized grads of ``params``, their
    ``.grad`` cleared again (a parameter the loss does not reach gets a
    zero grad, as in JAX)."""
    flat = adamw.leaves(params)
    loss.backward()
    grads = adamw.finalize_grads(tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
        params), model, ctx.comm, ctx.fsdp_groups, pipe_group, ctx.sp_group)
    for p in flat:
        p.grad = None
    return grads


def update_step(model, ctx, oc: adamw.OptConfig):
    """``apply`` of a :class:`TrainStep`: AdamW in place."""
    def apply(params, opt_state, grads, loss):
        metrics = adamw.adamw_update(params, grads, opt_state, oc, model,
                                     ctx.comm, ctx.fsdp_groups)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics
    return apply


def build_train_step(model, ctx, oc: adamw.OptConfig) -> TrainStep:
    """The :class:`TrainStep` of ``ctx.plan``.  ``params`` are the model's
    bf16 leaf tensors; ``grads`` marks them as requiring grad and runs
    ``backward()``."""
    check_fsdp_axes(model, ctx)
    check_sp(model, ctx)

    def grads(params, batch):
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        loss_sum, count, aux = model.loss_parts(params, batch, ctx)
        dp = tuple(ctx.axis_group(a) for a in dp_axes(model))
        loss_sum = psum_exact(loss_sum, dp)
        count = psum_exact(count.detach(), dp)
        loss = loss_sum / torch.clamp_min(count, 1.0)
        objective = loss
        if model.cfg.moe is not None:
            # the MoE balance loss joins what is differentiated; the
            # reported loss stays the cross-entropy (the JAX package's)
            n_dp = math.prod(group_size(g) for g in dp)
            objective = loss + 0.01 * psum_exact(aux, dp) / n_dp
        return backward_grads(params, objective, model, ctx), loss

    return TrainStep(grads, update_step(model, ctx, oc))


def build_eval_step(model, ctx):
    """``eval_step(params, batch) -> loss``: the JAX package's
    ``build_eval_step`` on one rank of the mesh.  The loss sum and the
    token count of this rank's rows are summed over the dp axes and their
    quotient (a 0-d f32 tensor on the device, the same on every rank) is
    returned; nothing is differentiated or written, and the MoE balance
    loss is left out, as the reference leaves it out."""
    check_fsdp_axes(model, ctx)
    check_sp(model, ctx)

    @torch.no_grad()
    def eval_step(params, batch):
        loss_sum, count, _ = model.loss_parts(params, batch, ctx)
        dp = tuple(ctx.axis_group(a) for a in dp_axes(model))
        loss_sum = psum_exact(loss_sum, dp)
        count = psum_exact(count, dp)
        return loss_sum / torch.clamp_min(count, 1.0)

    return eval_step
