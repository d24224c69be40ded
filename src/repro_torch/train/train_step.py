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
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import psum_exact
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw


def dp_axes(model) -> tuple:
    """Mesh axes the scalar loss and token count are summed over: the fsdp
    data axes (the batch is sharded over them)."""
    return model.fsdp_axes


def check_fsdp_axes(model, ctx) -> None:
    """The model's fsdp axes (how its weights are cut) must be the ctx's
    (the groups its collectives run over): the optimizer pairs them one to
    one."""
    if tuple(model.fsdp_axes) != tuple(ctx.fsdp_axes):
        raise ValueError(f"the model is cut over the fsdp axes "
                         f"{model.fsdp_axes}, the ctx's groups are over "
                         f"{ctx.fsdp_axes}")


def build_train_step(model, ctx, oc: adamw.OptConfig):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` are the model's bf16 leaf tensors; the step
    marks them as requiring grad, runs ``backward()`` and updates them and
    ``opt_state`` in place.  metrics: ``loss`` and ``grad_norm`` (0-d f32
    tensors on the device) and ``lr`` (float)."""
    check_fsdp_axes(model, ctx)

    def step(params, opt_state, batch):
        flat = adamw.leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss_sum, count, _ = model.loss_parts(params, batch, ctx)
        dp = tuple(ctx.axis_group(a) for a in dp_axes(model))
        loss_sum = psum_exact(loss_sum, dp)
        count = psum_exact(count.detach(), dp)
        loss = loss_sum / torch.clamp_min(count, 1.0)
        loss.backward()
        # a parameter the loss does not reach gets a zero grad, as in JAX
        grads = adamw.finalize_grads(tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            params), model, ctx.comm, ctx.fsdp_groups)
        for p in flat:
            p.grad = None
        metrics = adamw.adamw_update(params, grads, opt_state, oc, model,
                                     ctx.comm, ctx.fsdp_groups)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step
