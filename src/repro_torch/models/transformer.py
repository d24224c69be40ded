"""Transformer assembly: layer segments, per-layer and whole-model param
specs, the LM-head table.  The port covers the dense family (rmsnorm or
layernorm; swiglu, geglu or gelu; rope, learned or sinusoid positions;
sliding-window attention); the other families raise.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models import attention as attn_mod
# embed_partial and mlp_apply are re-exported where the JAX package has them
from repro_torch.models.layers import (  # noqa: F401
    ParamBuilder, embed_partial, embed_specs, mlp_apply, mlp_specs,
    norm_specs)

#: the later slice that ports each non-dense family
LATER_SLICE = {"moe": "the MoE slice (models/moe.py, ep_all_to_all)",
               "rwkv": "the SSM/RWKV slice (models/rwkv.py)",
               "hybrid": "the SSM/RWKV slice (models/ssm.py)",
               "encdec": "the encoder-decoder slice (cross-attention)"}


def check_family(cfg) -> None:
    """Raise for what this port does not cover yet."""
    if cfg.family != "dense":
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
    """Maximal runs of layers with one structure; a dense model is one
    segment (hybrid models' full/SWA interleave comes with their slice)."""
    check_family(cfg)
    kind = "swa" if cfg.window is not None else "full"
    return [Segment(kind, 0, cfg.n_layers)]


def block_specs(cfg, plan) -> dict:
    check_family(cfg)
    pb = ParamBuilder()
    d = cfg.d_model
    norm_specs(pb, "norm1", d, cfg.norm)
    norm_specs(pb, "norm2", d, cfg.norm)
    attn_mod.attn_specs(pb, "attn", cfg, plan)
    mlp_specs(pb, "mlp", d, cfg.d_ff, cfg.mlp)
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
