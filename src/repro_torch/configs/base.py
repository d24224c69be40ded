"""Architecture configuration system.

``ArchConfig`` is the hardware-independent description (straight from the
public sources). ``RunPlan`` is the mesh-dependent partitioning derived
from (config, tp, fsdp): head padding, KV replication-vs-sharding choice,
vocab padding (DESIGN.md §4 "Head padding").
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["MoeConfig", "SsmConfig", "ArchConfig", "RunPlan", "make_plan",
           "register", "get_config", "list_configs", "smoke_config"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    mlp: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    pos: str = "rope"           # rope | sinusoid | learned | none
    rope_theta: float = 10000.0
    window: int | None = None   # sliding-window attention size
    hybrid_full_attn: tuple = ()   # hymba: layer indices with full attention
    moe: MoeConfig | None = None
    ssm: SsmConfig | None = None
    enc_layers: int = 0         # whisper encoder depth
    frontend: str | None = None  # patches | frames (STUB embeddings per spec)
    frontend_tokens: int = 256  # prepended embeddings for vlm
    tie_embeddings: bool = False
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (spec: run for SSM/hybrid/linear-attn/SWA)."""
        return self.family in ("rwkv",) or self.ssm is not None or \
            self.window is not None

    @property
    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        per_layer = 0
        if self.family == "rwkv":
            # time-mix: r,k,v,g,o (5 d^2) + channel-mix (2 d*f + d^2) + small
            per_layer = 6 * d * d + 2 * d * f
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            n_mats = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.mlp]
            ff = n_mats * d * f
            if self.moe:
                ff *= self.moe.n_experts
            per_layer = attn + ff
            if self.ssm is not None:  # hymba parallel mamba branch
                di = d * self.ssm.expand
                per_layer += 2 * d * di + di * d + di * (2 * self.ssm.d_state + 1)
        total = (self.n_layers + self.enc_layers) * per_layer
        total += v * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """N_active for MoE: experts scaled by top_k/n_experts."""
        if not self.moe:
            return self.param_count
        d, f = self.d_model, self.d_ff
        n_mats = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.mlp]
        dense_ff = n_mats * d * f
        inactive = (self.moe.n_experts - self.moe.top_k) * dense_ff
        return self.param_count - self.n_layers * inactive


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """Mesh-dependent partitioning decisions (all static)."""

    tp: int
    fsdp: int
    heads_pad: int       # padded q heads, multiple of tp
    q_local: int         # q heads per device
    kv_mode: str         # "sharded" | "replicated"
    kv_pad: int          # padded kv heads (sharded mode) or n_kv (replicated)
    kv_local: int        # kv heads materialized per device
    vocab_pad: int
    dff_local: int
    remat: bool = True
    scan_layers: bool = True
    remat_policy: str = "full"   # full | dots | none
    attn_f32: bool = True        # decode attention accumulation dtype

    @property
    def group_size(self) -> int:
        return self.heads_pad // self.kv_pad if self.kv_mode == "sharded" else 0


def make_plan(cfg: ArchConfig, tp: int, fsdp: int, *, remat: bool = True,
              scan_layers: bool = True, remat_policy: str = "full",
              kv_strategy: str = "auto", attn_f32: bool = True) -> RunPlan:
    if cfg.family == "rwkv":
        n_heads = cfg.d_model // cfg.hd
        assert n_heads % tp == 0, f"rwkv heads {n_heads} vs tp {tp}"
        return RunPlan(tp=tp, fsdp=fsdp, heads_pad=n_heads,
                       q_local=n_heads // tp, kv_mode="sharded",
                       kv_pad=n_heads, kv_local=n_heads // tp,
                       vocab_pad=_round_up(cfg.vocab_size, max(128, tp)),
                       dff_local=cfg.d_ff // tp, remat=remat,
                       scan_layers=scan_layers, remat_policy=remat_policy,
                       attn_f32=attn_f32)
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if kv < tp and kv != h and kv_strategy == "pad_shard":
        # hillclimb variant: pad kv groups up to tp and SHARD the cache
        # (trades q/kv padding compute for tp-x less KV cache per device;
        # group-contiguous q order keeps the GQA mapping device-local)
        gsz = h // kv
        kv_pad, heads_pad = tp, tp * gsz
        kv_mode, kv_local = "sharded", 1
    elif kv >= tp or kv == h:
        # shard kv groups; pad group count to a multiple of tp (MHA always
        # shards — group size 1 pads cleanly even when kv < tp)
        gsz = h // kv
        kv_pad = _round_up(kv, tp)
        heads_pad = kv_pad * gsz
        kv_mode, kv_local = "sharded", kv_pad // tp
    else:
        # few kv heads (GQA): replicate them, shard (padded) q heads
        heads_pad = _round_up(h, tp)
        kv_mode, kv_pad, kv_local = "replicated", kv, kv
    assert cfg.d_ff % tp == 0, f"d_ff {cfg.d_ff} vs tp {tp}"
    return RunPlan(tp=tp, fsdp=fsdp, heads_pad=heads_pad,
                   q_local=heads_pad // tp, kv_mode=kv_mode,
                   kv_pad=kv_pad, kv_local=kv_local,
                   vocab_pad=_round_up(cfg.vocab_size, max(128, tp)),
                   dff_local=cfg.d_ff // tp, remat=remat,
                   scan_layers=scan_layers, remat_policy=remat_policy,
                   attn_f32=attn_f32)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _  # ensure registration side effects
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _
    return sorted(_REGISTRY)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (per spec: small
    layers/width, few experts, tiny vocab; same code paths)."""
    hd = 16
    n_heads = 8 if cfg.n_heads else 0
    if cfg.family == "rwkv":
        d_model, n_kv = 4 * hd, 0
    else:
        d_model = n_heads * hd
        if cfg.n_kv_heads == cfg.n_heads:
            n_kv = n_heads
        else:
            # nearest divisor of n_heads to the original GQA ratio, so the
            # group mapping stays exact
            want = max(1, round(n_heads * cfg.n_kv_heads
                                / max(cfg.n_heads, 1)))
            divs = [d for d in range(1, n_heads + 1) if n_heads % d == 0]
            n_kv = min(divs, key=lambda d: abs(d - want))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2,
        enc_layers=2 if cfg.enc_layers else 0,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=192,
        vocab_size=503,  # deliberately odd: exercises vocab padding
        window=min(cfg.window, 32) if cfg.window else None,
        moe=dataclasses.replace(cfg.moe, n_experts=min(4, cfg.moe.n_experts),
                                top_k=min(cfg.moe.top_k, 2)) if cfg.moe else None,
        ssm=dataclasses.replace(cfg.ssm, d_state=8) if cfg.ssm else None,
        frontend_tokens=8 if cfg.frontend else 0,
        hybrid_full_attn=(0,) if cfg.hybrid_full_attn else (),
    )
