"""Transformer assembly: layer segments, per-layer and whole-model param
specs, the LM-head table, and the training forward (decode lives in
``repro_torch/serve/serve_step.py``).  The port covers the dense family
(rmsnorm or layernorm; swiglu, geglu or gelu; rope, learned or sinusoid
positions; sliding-window attention), the MoE family (``models/moe.py``:
the block's MLP is a top-k routed expert layer), the RWKV family
(``models/rwkv.py``: time mix and channel mix in place of attention and
MLP) and the hybrid family (``models/ssm.py``: a selective SSM beside the
attention, the two summed through a learned gate, the layers cut into
full / sliding-window segments); the encoder-decoder raises.

The training forward runs Megatron-SP, as the JAX package: the residual
stream is sequence-sharded over the TP group, each block enters through a
compressed all-gather (``tp_enter``) and leaves through a compressed
reduce-scatter (``tp_exit``), and the embedding's exit and the final
entry are TACO sites too.  Under an active seq group the sequence is this
seq rank's shard, at its global positions.  Layers run one after another in a Python loop
(the JAX package scans them), each under ``torch.utils.checkpoint`` when
the plan asks for full recompute.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.codecs import IdentityCodec
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
# embed_partial and mlp_apply are re-exported where the JAX package has them
from repro_torch.models.layers import (  # noqa: F401
    COMPUTE_DTYPE, ParamBuilder, apply_norm, embed_partial, embed_specs,
    mlp_apply, mlp_specs, norm_specs, sinusoid_pos, tree_map,
    vocab_parallel_xent)

#: the later slice that ports each non-dense family
LATER_SLICE = {"encdec": "the encoder-decoder slice (cross-attention)"}

#: the families this port runs
FAMILIES = ("dense", "moe", "rwkv", "hybrid")


def check_family(cfg) -> None:
    """Raise for what this port does not cover yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is ported in "
            f"{LATER_SLICE.get(cfg.family, 'a later slice')}")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is ported in a "
            "later slice")


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str      # "full" | "swa"
    start: int
    count: int


def layer_segments(cfg) -> list[Segment]:
    """Maximal runs of layers with one structure: a hybrid model's layers
    listed in ``hybrid_full_attn`` run full attention and the others
    sliding-window attention (hymba-1.5b: full [0], swa [1-14], full
    [15], swa [16-30], full [31]); every other model is one segment.
    The structure alone: it holds for families the port does not run."""
    n = cfg.n_layers
    if cfg.family == "hybrid" and cfg.hybrid_full_attn:
        fulls = set(cfg.hybrid_full_attn)
        segs, cur = [], 0
        while cur < n:
            kind = "full" if cur in fulls else "swa"
            end = cur
            while end < n and ("full" if end in fulls else "swa") == kind:
                end += 1
            segs.append(Segment(kind, cur, end - cur))
            cur = end
        return segs
    kind = "swa" if cfg.window is not None else "full"
    return [Segment(kind, 0, n)]


def block_specs(cfg, plan) -> dict:
    check_family(cfg)
    pb = ParamBuilder()
    d = cfg.d_model
    norm_specs(pb, "norm1", d, cfg.norm)
    norm_specs(pb, "norm2", d, cfg.norm)
    if cfg.family == "rwkv":
        rwkv_mod.rwkv_specs(pb, "blk", cfg, plan)
        specs = pb.specs
        specs.update(specs.pop("blk"))
        return specs
    attn_mod.attn_specs(pb, "attn", cfg, plan)
    if cfg.family == "moe":
        moe_mod.moe_specs(pb, "moe", cfg, plan)
    else:
        mlp_specs(pb, "mlp", d, cfg.d_ff, cfg.mlp)
    if cfg.family == "hybrid":
        ssm_mod.ssm_specs(pb, "ssm", cfg, plan)
        pb.add("branch_gate", (2,), init="zeros")  # learned attn/ssm balance
    return pb.specs


def model_specs(cfg, plan) -> dict:
    pb = ParamBuilder()
    embed_specs(pb, plan.vocab_pad, cfg.d_model, cfg.tie_embeddings)
    if cfg.pos == "learned":
        pb.add("pos_embed", (8192, cfg.d_model), fsdp_dim=0, scale=0.01)
    norm_specs(pb, "final_norm", cfg.d_model, cfg.norm)
    specs = pb.specs
    per_layer = block_specs(cfg, plan)
    specs["segments"] = [ParamBuilder.stack(per_layer, seg.count)
                         for seg in layer_segments(cfg)]
    return specs


def head_table(params, cfg):
    return params["embed"]["table"] if cfg.tie_embeddings \
        else params["head"]["table"]


# --------------------------------------------------------------------------
# residual-stream TP helpers (SP vs AllReduce mode)
# --------------------------------------------------------------------------

def tp_enter(x_shard, ctx):
    """seq-sharded residual -> full-seq activations (TACO site:
    all-gather)."""
    if ctx.tp_mode == "sp":
        return ctx.sp_gather(x_shard, 1)
    return ctx.tp_f(x_shard)


def tp_exit(y_partial, ctx):
    """tp-partial block output -> seq-sharded residual (TACO site:
    reduce-scatter)."""
    if ctx.tp_mode == "sp":
        return ctx.sp_scatter(y_partial, 1)
    return ctx.tp_g(y_partial)


def seq_slice(x_full, ctx, tp: int):
    """Full-seq (replicated) -> this rank's seq shard, no communication."""
    if ctx.tp_mode != "sp" or tp == 1:
        return x_full
    s_loc = x_full.shape[1] // tp
    return x_full[:, ctx.tp_rank * s_loc:(ctx.tp_rank + 1) * s_loc]


# --------------------------------------------------------------------------
# block forward (train path; full sequence)
# --------------------------------------------------------------------------

def block_apply(x_shard, lp, cfg, plan, ctx, *, attn_kind: str, positions,
                causal=True):
    """One transformer block on the seq-sharded residual stream: four TACO
    sites (two entries, two exits).  Returns ``(x_shard, aux)``: aux is
    the MoE layer's balance loss (f32), None for a dense MLP.

    An RWKV block's time mix and channel mix take the attention's and
    the MLP's sites; a hybrid block adds the SSM branch to the attention's
    partial output through the learned gate, before the exit."""
    window = cfg.window if attn_kind == "swa" else None
    if cfg.family == "rwkv":
        h_full = tp_enter(apply_norm(x_shard, lp["norm1"], cfg.norm,
                                     cfg.norm_eps), ctx)
        out, _ = rwkv_mod.time_mix_apply(h_full, lp, cfg, plan, ctx)
        x_shard = x_shard + tp_exit(out, ctx)
        h_full = tp_enter(apply_norm(x_shard, lp["norm2"], cfg.norm,
                                     cfg.norm_eps), ctx)
        out, _ = rwkv_mod.channel_mix_apply(h_full, lp, cfg, plan, ctx)
        return x_shard + tp_exit(out, ctx), None
    h = apply_norm(x_shard, lp["norm1"], cfg.norm, cfg.norm_eps)
    h_full = tp_enter(h, ctx)
    partial = attn_mod.attention_apply(h_full, lp["attn"], cfg, plan, ctx,
                                       causal=causal, window=window,
                                       positions=positions)
    if cfg.family == "hybrid":
        ssm_out, _ = ssm_mod.ssm_apply(h_full, lp["ssm"], cfg, plan, ctx)
        partial = gated_sum(partial, ssm_out, lp["branch_gate"])
    x_shard = x_shard + tp_exit(partial, ctx)
    h = apply_norm(x_shard, lp["norm2"], cfg.norm, cfg.norm_eps)
    h_full = tp_enter(h, ctx)
    aux = None
    if cfg.family == "moe":
        partial, aux = moe_mod.moe_apply(h_full, lp["moe"], cfg, plan, ctx)
    else:
        partial = mlp_apply(h_full, lp["mlp"], cfg.mlp, ctx)
    out = tp_exit(partial, ctx)
    if cfg.mlp == "gelu":
        out = out + lp["mlp"]["b2"].to(out.dtype)
    return x_shard + out, aux


def gated_sum(partial, ssm_out, gate):
    """The hybrid block's mix of its two branches: ``partial *
    sigmoid(gate)[0] + ssm_out * sigmoid(gate)[1]``, the gates rounded to
    the compute dtype."""
    gates = torch.sigmoid(gate.float()).to(COMPUTE_DTYPE)
    return partial * gates[0] + ssm_out * gates[1]


def run_segments(x_shard, seg_params, segments, cfg, plan, ctx, *,
                 positions, causal=True):
    """Run each segment's stacked layers in order on the residual stream;
    returns ``(x_shard, aux_sum)``, the layers' MoE balance losses summed
    (f32; 0 for the dense family).

    Per-layer CommPlan overrides (``skip_first`` / ``skip_last``) are
    resolved into spans of layers sharing one plan.  With ``plan.remat``
    and ``remat_policy == "full"`` each layer runs under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` with
    ``nothing_saveable``): only the layer's input is kept, and the backward
    recomputes the layer up to its last saved activation — the block's
    final reduce-scatter, which saves nothing, is not recomputed."""
    from repro_torch.core.parallel import iter_layer_spans
    remat = plan.remat and plan.remat_policy != "none"
    if remat and plan.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={plan.remat_policy!r} is not ported; the port "
            "recomputes whole layers (remat_policy='full') or none")
    n_total = max(s.start + s.count for s in segments)
    aux_total = torch.zeros((), device=x_shard.device)
    for seg, sp_ in zip(segments, seg_params):
        for span_n, span_ctx, sp_span in iter_layer_spans(
                ctx, seg.start, seg.count, n_total, sp_):

            def blk(x, lp, kind=seg.kind, c=span_ctx):
                return block_apply(x, lp, cfg, plan, c, attn_kind=kind,
                                   positions=positions, causal=causal)

            for i in range(span_n):
                lp = tree_map(lambda a, i=i: a[i], sp_span)
                if remat:
                    x_shard, a = checkpoint(blk, x_shard, lp,
                                            use_reentrant=False)
                else:
                    x_shard, a = blk(x_shard, lp)
                if a is not None:
                    aux_total = aux_total + a
    return x_shard, aux_total


# --------------------------------------------------------------------------
# train forward (loss)
# --------------------------------------------------------------------------

def add_positional(x_shard, params, cfg, ctx, seq: int):
    """Learned / sinusoid absolute positions, added on the seq shard."""
    if cfg.pos not in ("learned", "sinusoid"):
        return x_shard
    s_loc = x_shard.shape[1]
    start = ctx.tp_rank * s_loc if ctx.tp_mode == "sp" else 0
    # under an active seq group, seq is the seq shard's length: offset to
    # the global positions
    start += ctx.sp_index() * seq
    if cfg.pos == "learned":
        table = ctx.weight_gather(params["pos_embed"], 0)
        pe = table[start:start + s_loc]
    else:
        pe = torch.from_numpy(sinusoid_pos(seq * ctx.sp_size(), cfg.d_model)[
            start:start + s_loc]).to(x_shard.device, COMPUTE_DTYPE)
    return x_shard + pe[None].to(x_shard.dtype)


def forward_train(params, batch, cfg, plan, ctx):
    """batch: tokens (B, S), labels (B, S), mask (B, S) — under an active
    seq group this rank's shard of the sequence, at positions offset by
    ``sp_index() * S``.  Returns ``(loss_sum, token_count, aux)`` as f32
    scalars, local to this rank (aux, the layers' summed MoE balance loss,
    is 0 for the dense family)."""
    check_family(cfg)
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    # embedding (vocab-parallel; TACO reduce-scatter site)
    partial = embed_partial(tokens, params["embed"]["table"], ctx)
    seq = partial.shape[1]
    x = tp_exit(partial, ctx)
    x = add_positional(x, params, cfg, ctx, seq)
    positions = ctx.sp_index() * seq + torch.arange(seq, device=x.device)
    x, aux = run_segments(x, params["segments"], layer_segments(cfg), cfg,
                          plan, ctx, positions=positions, causal=True)
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    x_full = tp_enter(x, ctx)                          # TACO gather site
    loss_sum, count = vocab_parallel_xent(x_full, head_table(params, cfg),
                                          labels, mask, ctx, plan)
    return loss_sum, count, aux


def tp_hops_per_step(cfg, plan, comm_plan, sp: int = 1,
                     sp_mode: str = "ulysses") -> dict:
    """Compressed hops that one Megatron-SP training step runs, by kind:
    each all-gather hop runs one compress and one decompress, each
    reduce-scatter hop one compress and one decompress-reduce, and each
    sequence-parallel hop (an all-to-all or a permute over a seq group of
    ``sp`` ranks) one compress and one decompress.

    Forward: every compressed layer enters twice and exits twice, plus the
    embedding's exit and the final entry.  Backward: each forward hop's
    conjugate (an all-gather's is a reduce-scatter and back).  Full
    recompute (``plan.remat``) runs each layer's forward again up to its
    last saved activation, i.e. both entries and the attention exit; the
    MLP exit saves nothing, so ``torch.utils.checkpoint`` stops before it.
    Hops whose codec is the identity (``skip_first`` / ``skip_last``
    layers, an uncompressed direction) run no codec and are not counted.

    The sp hops of a layer's attention: Ulysses' two all-to-alls, or the
    ring's ``sp - 1`` permutes; the backward runs each one's conjugate
    (an all-to-all, a permute) and full recompute runs them again (they
    come before the attention exit).  At ``sp = 1`` both flavours run the
    monolithic core, with no hop, and so does an identity ``sp`` codec
    count none."""
    n = cfg.n_layers
    layers = sum(c for c, p in comm_plan.layer_spans(0, n, n)
                 if not p.tp_identity)
    f = not isinstance(comm_plan.tp_fwd, IdentityCodec)
    b = not isinstance(comm_plan.tp_bwd, IdentityCodec)
    remat = plan.remat and plan.remat_policy != "none"
    ag = f * (2 * layers + 1) + f * remat * 2 * layers + b * (2 * layers + 1)
    rs = f * (2 * layers + 1) + f * remat * layers + b * (2 * layers + 1)
    on = sp > 1 and not isinstance(comm_plan.sp, IdentityCodec)
    per_layer = on * (2 if sp_mode == "ulysses" else sp - 1)
    sp_hops = per_layer * n * (2 + remat)
    return {"all_gather": ag, "reduce_scatter": rs,
            "all_to_all": sp_hops if sp_mode == "ulysses" else 0,
            "permute": sp_hops if sp_mode == "ring" else 0}
