"""The training step: loss, backward through the compressed collectives,
AdamW — the JAX package's ``repro/train/train_step.py`` on one rank of the
TP group.

Every TP hop of the forward is a compressed collective whose backward is
its conjugate (``core/collectives.py``), so the backward moves compressed
cotangents through the ``tp_bwd`` codec.  Every rank of the group takes
the same batch; the loss is the group's (the cross-entropy's softmax
statistics are summed over the group, so every rank holds the same value)
and so is the grad norm.  There is no data axis yet, so the JAX step's
psums of the loss and the token count over the dp axes are the identity.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw


def build_train_step(model, ctx, oc: adamw.OptConfig):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` are the model's bf16 leaf tensors; the step
    marks them as requiring grad, runs ``backward()`` and updates them and
    ``opt_state`` in place.  metrics: ``loss`` and ``grad_norm`` (0-d f32
    tensors on the device) and ``lr`` (float)."""

    def step(params, opt_state, batch):
        flat = adamw.leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss_sum, count, _ = model.loss_parts(params, batch, ctx)
        loss = loss_sum / torch.clamp_min(count.detach(), 1.0)
        loss.backward()
        # a parameter the loss does not reach gets a zero grad, as in JAX
        grads = adamw.finalize_grads(tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            params), model, ctx.comm)
        for p in flat:
            p.grad = None
        metrics = adamw.adamw_update(params, grads, opt_state, oc, model,
                                     ctx.comm)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step
