"""Pipeline parallelism (paper §5.5: 3D = DP x TP x PP with TahQuant-
compressed stage boundaries, TACO on TP and SDP4bit on DP) — the JAX
package's ``repro/train/pipeline_parallel.py`` on one rank of the
``("pipe", "data", "model")`` mesh (``launch/mesh.py`` ``PIPE_AXES``).

A GPipe schedule, the reference's tick loop as it is: M microbatches flow
through P stages over M + P - 1 ticks.  At tick t, stage s works on
microbatch ``clamp(t - s, 0, M - 1)``; stage 0 takes its input from the
embedding while t < M, every other stage (and stage 0 after that) from
what the stage before sent at the tick before.  Every stage computes its
layers, the final norm and the loss every tick, and the bubble ticks are
masked — the GPipe cost model, and the reference's: the embedding is
selected only on stage 0 before tick M (``torch.where``), the loss counts
only on the last stage from tick P - 1 on.  Each tick ends with one
boundary hop, ``core/collectives.py`` ``ppermute_c`` over the pipe group
through the ``pp`` codec (the TahQuant site): stage s sends to stage
s + 1, and the backward sends the cotangents back through the same
codec.

Stage s owns layers ``[s * L/P, (s + 1) * L/P)`` of the layer stack
(``models.model.Model`` with ``pipe`` and ``pipe_rank``); the embedding,
the positions, the final norm and the head are whole on every stage, and
their grads are summed over the pipe group too (``adamw.finalize_grads``
with the pipe group: the JAX package's ``_finalize_pipe_grads``).
The TP and fsdp sharding inside a stage is the unpipelined one, so the
TACO sites are the same.  The loss sum and the token count are summed over
the pipe and the data groups.

The optimizer is ``optim/adamw.py`` on the stage's own state: the master
weights and moments of a stage hold only its layers.  The clip norm is
the JAX package's: summed over the fsdp and TP groups, never over pipe, so
each stage clips with the norm of its own layers and the replicated
parameters, and each rank reports its own stage's (the reference's step
reports stage 0's).

Scope, as the reference: decoder-only families with one layer segment
and the token frontend (the reference silently drops frames and
patches; the port refuses both), ``n_layers`` divisible by the stages,
no per-layer or warmup overrides in the plan.  There is no launcher
flag: this builder is the entry point, called as the JAX package's
``tests/multidev/check_pipeline.py`` calls its twin.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import collectives as cc
from repro_torch.models import layers, transformer
from repro_torch.models.layers import apply_norm
from repro_torch.optim import adamw
from repro_torch.train.train_step import (TrainStep, backward_grads,
                                          check_fsdp_axes, update_step)


@dataclasses.dataclass(frozen=True)
class PipeConfig:
    stages: int
    microbatches: int


def _stage_forward(x_shard, seg_params_local, model, ctx, positions):
    """Run this stage's local layer slice (stacked dim = L/P) on the
    residual stream, each layer under ``torch.utils.checkpoint`` when the
    plan recomputes (``transformer.run_segments``).  The MoE balance loss
    is dropped, as the JAX package's ``_stage_forward`` drops it: the
    pipeline step trains on the cross-entropy alone."""
    cfg = model.cfg
    seg = transformer.layer_segments(cfg)[0]
    count = cfg.n_layers // model.pipe
    local = transformer.Segment(seg.kind, 0, count)
    x_shard, _ = transformer.run_segments(
        x_shard, seg_params_local, [local], cfg, model.plan, ctx,
        positions=positions, causal=True)
    return x_shard


def build_pipeline_train_step(model, ctx, oc: adamw.OptConfig,
                              pc: PipeConfig):
    """Returns the ``train_step.TrainStep`` of this rank's stage, as
    ``train_step.build_train_step`` does (``step(params, opt_state, batch)
    -> (params, opt_state, metrics)``, params updated in place; metrics
    ``loss``, ``grad_norm`` and ``lr``).  ``model`` is this rank's stage (``pipe == pc.stages``),
    ``ctx`` carries the pipe group (``launch.mesh.Mesh.parallel_ctx`` of
    the pipe mesh) and the batch is this rank's data rows."""
    cfg = model.cfg
    check_fsdp_axes(model, ctx)
    if cfg.family == "encdec" or cfg.frontend is not None:
        # the JAX package's pipeline step reads only tokens, labels and
        # mask (src/repro/train/pipeline_parallel.py:115-116) and runs its
        # layers with enc_kv=None (:72-73): it would train whisper's decoder
        # with no encoder and drop internvl's patches, without a word
        raise NotImplementedError(
            f"{cfg.name}: the pipeline step runs the token frontend only; "
            f"the JAX package's drops the {cfg.frontend!r} stubs "
            "(src/repro/train/pipeline_parallel.py:115-116 reads tokens, "
            "labels and mask) and the encoder (blk passes enc_kv=None, "
            ":72-73)")
    if len(transformer.layer_segments(cfg)) != 1:
        raise NotImplementedError("the pipeline step runs single-segment "
                                  "archs")
    if cfg.n_layers % pc.stages or model.pipe != pc.stages:
        raise ValueError(f"{cfg.n_layers} layers over {pc.stages} stages "
                         f"(the model is cut into {model.pipe})")
    plan = ctx.plan
    if plan.skip_first or plan.skip_last or plan.warmup_steps:
        # one step runs every stage with its own layers; the reference
        # refuses per-layer and warmup overrides rather than compressing
        # layers the plan promised to skip
        raise NotImplementedError(
            "pipeline-parallel step does not support per-layer overrides "
            "(skip_first/skip_last) or warmup scheduling; strip them from "
            f"the CommPlan (got {plan})")
    if cc.group_size(ctx.pipe_group) != pc.stages or \
            cc.group_rank(ctx.pipe_group) != model.pipe_rank:
        raise ValueError(f"the pipe group (rank {cc.group_rank(ctx.pipe_group)}"
                         f" of {cc.group_size(ctx.pipe_group)}) is not "
                         f"stage {model.pipe_rank} of {pc.stages}")
    stage, stages, m = model.pipe_rank, pc.stages, pc.microbatches
    perm_fwd = tuple((i, i + 1) for i in range(stages - 1))
    over = (ctx.pipe_group,) + tuple(ctx.fsdp_groups)

    def loss_fn(params, batch):
        tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
        b, s_tok = tokens.shape
        if b % m:
            raise ValueError(f"{b} rows do not split into {m} microbatches")
        bm = b // m
        positions = torch.arange(s_tok, device=tokens.device)
        s_loc = s_tok // model.plan.tp if ctx.tp_mode == "sp" else s_tok
        x = torch.zeros((bm, s_loc, cfg.d_model), dtype=layers.COMPUTE_DTYPE,
                        device=tokens.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        count = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t in range(m + stages - 1):
            # stage 0 sources microbatch t (if any)
            mb = min(max(t - stage, 0), m - 1)
            rows = slice(mb * bm, (mb + 1) * bm)
            emb = transformer.embed_partial(tokens[rows],
                                            params["embed"]["table"], ctx)
            x0 = transformer.tp_exit(emb, ctx)
            x0 = transformer.add_positional(x0, params, cfg, ctx, s_tok)
            first = torch.tensor(stage == 0 and t < m, device=x.device)
            x_in = torch.where(first, x0, x)
            # every stage computes its slice (bubble ticks masked)
            x_out = _stage_forward(x_in, params["segments"], model, ctx,
                                   positions)
            # the last stage: the loss of its current microbatch
            h = apply_norm(x_out, params["final_norm"], cfg.norm,
                           cfg.norm_eps)
            h_full = transformer.tp_enter(h, ctx)
            ls, cnt = transformer.vocab_parallel_xent(
                h_full, transformer.head_table(params, cfg), labels[rows],
                mask[rows], ctx, model.plan)
            valid = float(stage == stages - 1 and t >= stages - 1)
            loss_sum = loss_sum + ls * valid
            count = count + cnt * valid
            # ship the activations forward (the TahQuant site)
            x = cc.ppermute_c(x_out, ctx.pipe_group, perm_fwd,
                              ctx.plan.pp, ctx.plan.pp)
        loss_sum = cc.psum_exact(loss_sum, over)
        count = cc.psum_exact(count.detach(), over)
        return loss_sum / torch.clamp_min(count, 1.0)

    def grads(params, batch):
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        return backward_grads(params, loss, model, ctx, ctx.pipe_group), loss

    return TrainStep(grads, update_step(model, ctx, oc))


def boundary_hops_per_step(pc: PipeConfig) -> dict:
    """Boundary hops (``ppermute_c``) one step makes on every rank: one a
    tick forward; backward one a tick but the last, whose send reaches no
    later tick."""
    ticks = pc.microbatches + pc.stages - 1
    return {"forward": ticks, "backward": ticks - 1}
