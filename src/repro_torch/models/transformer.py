"""Transformer assembly: layer segments, per-layer and whole-model param
specs, the LM-head table, and the training forward (decode lives in
``repro_torch/serve/serve_step.py``).  The port covers the dense family
(rmsnorm or layernorm; swiglu, geglu or gelu; rope, learned or sinusoid
positions; sliding-window attention), the MoE family (``models/moe.py``:
the block's MLP is a top-k routed expert layer), the RWKV family
(``models/rwkv.py``: time mix and channel mix in place of attention and
MLP), the hybrid family (``models/ssm.py``: a selective SSM beside the
attention, the two summed through a learned gate, the layers cut into
full / sliding-window segments) and the encoder-decoder (whisper: a
non-causal encoder over stub frame embeddings, each decoder layer with a
cross-attention over the encoder's output), plus the patch frontend
(stub patch embeddings put in front of the token embedding).

The training forward runs Megatron-SP, as the JAX package: the residual
stream is sequence-sharded over the TP group, each block enters through a
compressed all-gather (``tp_enter``) and leaves through a compressed
reduce-scatter (``tp_exit``), and the embedding's exit and the final
entry are TACO sites too.  Under an active seq group the sequence is this
seq rank's shard, at its global positions.  Layers run one after another in a Python loop
(the JAX package scans them), each under ``torch.utils.checkpoint`` when
the plan recomputes: every op (``remat_policy='full'``) or every op but
the non-batched matmuls (``'dots'``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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

#: the families this port runs
FAMILIES = ("dense", "moe", "rwkv", "hybrid", "encdec")
#: the stub frontends: frame embeddings for the encoder, patch embeddings
#: in front of the tokens
FRONTENDS = (None, "frames", "patches")


def check_family(cfg) -> None:
    """Raise for a family or a frontend the JAX package does not have."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(f"{cfg.name}: unknown frontend "
                                  f"{cfg.frontend!r}")


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


def block_specs(cfg, plan, *, cross: bool = False) -> dict:
    """One layer's specs; ``cross`` adds a whisper decoder layer's
    ``norm_x`` and cross-attention ``xattn``."""
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
    if cross:
        norm_specs(pb, "norm_x", d, cfg.norm)
        attn_mod.attn_specs(pb, "xattn", cfg, plan)
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
    per_layer = block_specs(cfg, plan, cross=cfg.family == "encdec")
    specs["segments"] = [ParamBuilder.stack(per_layer, seg.count)
                         for seg in layer_segments(cfg)]
    if cfg.family == "encdec":
        specs["enc_segments"] = [ParamBuilder.stack(
            block_specs(cfg, plan), cfg.enc_layers)]
        pb2 = ParamBuilder()
        norm_specs(pb2, "enc_final_norm", cfg.d_model, cfg.norm)
        specs.update(pb2.specs)
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
                causal=True, enc_kv=None):
    """One transformer block on the seq-sharded residual stream: four TACO
    sites (two entries, two exits).  Returns ``(x_shard, aux)``: aux is
    the MoE layer's balance loss (f32), None for a dense MLP.

    An RWKV block's time mix and channel mix take the attention's and
    the MLP's sites; a hybrid block adds the SSM branch to the attention's
    partial output through the learned gate, before the exit.  With
    ``enc_kv`` (the encoder's output, (B, S_enc, D) full-seq) a whisper
    decoder block adds a cross-attention sub-block between the two, with
    an entry and an exit of its own: six sites."""
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
    if enc_kv is not None:
        h_full = tp_enter(apply_norm(x_shard, lp["norm_x"], cfg.norm,
                                     cfg.norm_eps), ctx)
        partial = attn_mod.attention_apply(
            h_full, lp["xattn"], cfg, plan, ctx, causal=False, window=None,
            positions=positions, kv_source=enc_kv)
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


#: the ops whose outputs ``remat_policy='dots'`` keeps: the matmuls with
#: no batch dims (a (B, S, D) @ (D, F) product runs as one ``mm``), as
#: ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps them;
#: the attention's batched products (``bmm``) are recomputed
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_kwargs(plan) -> dict | None:
    """``torch.utils.checkpoint`` keyword arguments of the plan's
    recompute policy, or None when layers are not recomputed: ``'full'``
    saves nothing, any other policy the non-batched matmuls (the JAX
    package's choice between its two policies)."""
    if not plan.remat or plan.remat_policy == "none":
        return None
    kw = {"use_reentrant": False}
    if plan.remat_policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return kw


def run_segments(x_shard, seg_params, segments, cfg, plan, ctx, *,
                 positions, causal=True, enc_kv=None):
    """Run each segment's stacked layers in order on the residual stream;
    returns ``(x_shard, aux_sum)``, the layers' MoE balance losses summed
    (f32; 0 for the dense family).  ``enc_kv`` (the encoder's output) goes
    to every layer's cross-attention, and under recompute it is an input
    of the checkpointed layer.

    Per-layer CommPlan overrides (``skip_first`` / ``skip_last``) are
    resolved into spans of layers sharing one plan, over these segments'
    layers alone (the encoder's and the decoder's runs each count from
    0).  With ``plan.remat`` each layer runs under
    ``torch.utils.checkpoint`` (:func:`remat_kwargs`):
    ``remat_policy='full'`` is the JAX package's ``nothing_saveable``, only
    the layer's input is kept, and the backward recomputes the layer up to
    its last saved activation — the block's final reduce-scatter, which
    saves nothing, is not recomputed; ``'dots'`` keeps the non-batched
    matmuls' outputs as well and recomputes the rest over the same span,
    so it runs the same hops and gives the same gradients bit for bit."""
    from repro_torch.core.parallel import iter_layer_spans
    remat = remat_kwargs(plan)
    n_total = max(s.start + s.count for s in segments)
    aux_total = torch.zeros((), device=x_shard.device)
    for seg, sp_ in zip(segments, seg_params):
        for span_n, span_ctx, sp_span in iter_layer_spans(
                ctx, seg.start, seg.count, n_total, sp_):

            def blk(x, lp, ek, kind=seg.kind, c=span_ctx):
                return block_apply(x, lp, cfg, plan, c, attn_kind=kind,
                                   positions=positions, causal=causal,
                                   enc_kv=ek)

            for i in range(span_n):
                lp = tree_map(lambda a, i=i: a[i], sp_span)
                if remat is not None:
                    x_shard, a = checkpoint(blk, x_shard, lp, enc_kv,
                                            **remat)
                else:
                    x_shard, a = blk(x_shard, lp, enc_kv)
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


def encoder_forward(params, frames, cfg, plan, ctx):
    """The whisper encoder: stub frame embeddings (B, S_enc, D) -> its
    output (B, S_enc, D), full-seq, for the decoder's cross-attention.
    The frames are replicated, so each rank takes its seq shard with no
    hop; the layers are non-causal, and one TACO all-gather ends it."""
    s_enc = frames.shape[1]
    x = seq_slice(frames.to(COMPUTE_DTYPE), ctx, plan.tp)
    x = add_positional(x, params, cfg, ctx, s_enc)
    x, _ = run_segments(x, params["enc_segments"],
                        [Segment("full", 0, cfg.enc_layers)], cfg, plan, ctx,
                        positions=torch.arange(s_enc, device=x.device),
                        causal=False)
    x = apply_norm(x, params["enc_final_norm"], cfg.norm, cfg.norm_eps)
    return tp_enter(x, ctx)                            # TACO gather site


def forward_train(params, batch, cfg, plan, ctx):
    """batch: tokens (B, S), labels (B, S), mask (B, S) — under an active
    seq group this rank's shard of the sequence, at positions offset by
    ``sp_index() * S`` — plus the stubs of a frontend: ``frames`` (B,
    S_enc, D) for the encoder-decoder, ``patches`` (B, T, D) put in front
    of the token embedding (on TP rank 0 only, before its reduce-scatter),
    with zero labels and mask in front of the tokens'.  Returns
    ``(loss_sum, token_count, aux)`` as f32 scalars, local to this rank
    (aux, the layers' summed MoE balance loss, is 0 but for the MoE
    family)."""
    check_family(cfg)
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    enc_kv = None
    if cfg.family == "encdec":
        enc_kv = encoder_forward(params, batch["frames"], cfg, plan, ctx)
    # embedding (vocab-parallel; TACO reduce-scatter site)
    partial = embed_partial(tokens, params["embed"]["table"], ctx)
    if cfg.frontend == "patches":
        patches = batch["patches"].to(COMPUTE_DTYPE)
        pat = patches if ctx.tp_rank == 0 else torch.zeros_like(patches)
        partial = torch.cat([pat, partial], dim=1)
        lead = pat.shape[:2]
        labels = torch.cat([torch.zeros(lead, dtype=labels.dtype,
                                        device=labels.device), labels], 1)
        mask = torch.cat([torch.zeros(lead, dtype=mask.dtype,
                                      device=mask.device), mask], 1)
    seq = partial.shape[1]
    x = tp_exit(partial, ctx)
    x = add_positional(x, params, cfg, ctx, seq)
    positions = ctx.sp_index() * seq + torch.arange(seq, device=x.device)
    x, aux = run_segments(x, params["segments"], layer_segments(cfg), cfg,
                          plan, ctx, positions=positions, causal=True,
                          enc_kv=enc_kv)
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

    Forward: every compressed layer enters twice and exits twice (a
    whisper decoder layer three times: its cross-attention), plus the
    embedding's exit and the final entry; the whisper encoder's layers
    enter and exit twice each, its frames are sliced with no hop, and its
    output is gathered once.  Backward: each forward hop's conjugate (an
    all-gather's is a reduce-scatter and back).  Recompute (``plan.remat``,
    ``'full'`` or ``'dots'``) runs each layer's forward again up to its
    last saved activation, i.e. every entry and every exit but the last;
    the MLP exit saves nothing, so ``torch.utils.checkpoint`` stops before
    it.  ``skip_first`` / ``skip_last`` count over the encoder's and the
    decoder's layers apart.  Hops whose codec is the identity (skipped
    layers, an uncompressed direction) run no codec and are not counted.

    The sp hops of a layer's attention: Ulysses' two all-to-alls, or the
    ring's ``sp - 1`` permutes; the backward runs each one's conjugate
    (an all-to-all, a permute) and full recompute runs them again (they
    come before the attention exit).  At ``sp = 1`` both flavours run the
    monolithic core, with no hop, and so does an identity ``sp`` codec
    count none."""
    def compressed(n):
        return sum(c for c, p in comm_plan.layer_spans(0, n, n)
                   if not p.tp_identity)
    n = cfg.n_layers
    encdec = cfg.family == "encdec"
    sites = 3 if encdec else 2          # entries (= exits) of a layer
    enc = compressed(cfg.enc_layers) if encdec else 0
    dec = compressed(n)
    f = not isinstance(comm_plan.tp_fwd, IdentityCodec)
    b = not isinstance(comm_plan.tp_bwd, IdentityCodec)
    remat = plan.remat and plan.remat_policy != "none"
    fwd_ag = sites * dec + 2 * enc + 1 + encdec
    fwd_rs = sites * dec + 2 * enc + 1
    re_ag = sites * dec + 2 * enc
    re_rs = (sites - 1) * dec + enc
    ag = f * fwd_ag + f * remat * re_ag + b * fwd_rs
    rs = f * fwd_rs + f * remat * re_rs + b * fwd_ag
    on = sp > 1 and not isinstance(comm_plan.sp, IdentityCodec)
    per_layer = on * (2 if sp_mode == "ulysses" else sp - 1)
    sp_hops = per_layer * n * (2 + remat)
    return {"all_gather": ag, "reduce_scatter": rs,
            "all_to_all": sp_hops if sp_mode == "ulysses" else 0,
            "permute": sp_hops if sp_mode == "ring" else 0}
