"""Shared model layers.  Every function works on this process's local
tensors; all cross-device movement goes through the ``ParallelCtx``
collectives.  Weights keep the JAX package's layouts (``x @ w`` with w
(in, out)), so parameters carry across unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple          # global shape
    fsdp_dim: int | None  # dim sharded over fsdp axes (storage only)
    tp_dim: int | None    # dim sharded over the model axis
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02


class ParamBuilder:
    """Collects a nested dict of ParamSpecs."""

    def __init__(self):
        self.specs: dict = {}

    def add(self, name: str, shape, fsdp_dim=None, tp_dim=None,
            init="normal", scale=0.02):
        node = self.specs
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = ParamSpec(tuple(shape), fsdp_dim, tp_dim, init,
                                    scale)

    @staticmethod
    def stack(specs: dict, n: int) -> dict:
        """Add a leading layer dim of size n to every spec."""
        def f(s: ParamSpec) -> ParamSpec:
            return ParamSpec(
                (n,) + s.shape,
                None if s.fsdp_dim is None else s.fsdp_dim + 1,
                None if s.tp_dim is None else s.tp_dim + 1,
                s.init, s.scale)
        return tree_map(f, specs)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (sorted dict keys,
    the JAX package's pytree order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def init_param(spec: ParamSpec, generator: torch.Generator, device,
               dtype=COMPUTE_DTYPE) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * spec.scale).to(dtype)


def init_params(specs, seed: int, device, dtype=COMPUTE_DTYPE, cut=None):
    """Random parameters from ``torch.Generator`` seeded with ``seed``,
    drawn leaf by leaf in pytree order; ``cut(spec, leaf)``, when given,
    keeps a part of each leaf as soon as it is drawn (a rank's shard)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if cut is None:
        return tree_map(lambda s: init_param(s, gen, device, dtype), specs)
    return tree_map(lambda s: cut(s, init_param(s, gen, device, dtype)),
                    specs)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float()) + bias.float()).to(x.dtype)


def norm_specs(pb: ParamBuilder, name: str, d: int, kind: str):
    pb.add(f"{name}.scale", (d,), init="zeros")
    if kind == "layernorm":
        pb.add(f"{name}.bias", (d,), init="zeros")


def apply_norm(x, p, kind: str, eps: float):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


# --------------------------------------------------------------------------
# positional encodings
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, hd, 2) / hd))


def apply_rope(x, positions, theta: float):
    """x (B, S, H, hd), positions (S,) or (B, S) integer tensor."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    pos = positions.float()
    if pos.dim() == 1:
        ang = (pos[None, :, None] * freqs[None, None, :])[:, :, None, :]
    else:
        ang = (pos[:, :, None] * freqs[None, None, :])[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos(seq: int, d: int, offset: int = 0) -> np.ndarray:
    """(seq, d) f32 sinusoid position table (numpy; the caller casts)."""
    pos = np.arange(offset, offset + seq)[:, None]
    div = np.exp(np.arange(0, d, 2) / d * -np.log(10000.0))[None, :]
    table = np.zeros((seq, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_specs(pb: ParamBuilder, name: str, d: int, f: int, kind: str):
    if kind in ("swiglu", "geglu"):
        pb.add(f"{name}.w1", (d, f), fsdp_dim=0, tp_dim=1)
        pb.add(f"{name}.w3", (d, f), fsdp_dim=0, tp_dim=1)
    else:
        pb.add(f"{name}.w1", (d, f), fsdp_dim=0, tp_dim=1)
        pb.add(f"{name}.b1", (f,), tp_dim=0, init="zeros")
        pb.add(f"{name}.b2", (d,), init="zeros")
    pb.add(f"{name}.w2", (f, d), fsdp_dim=1, tp_dim=0)


def mlp_apply(x_full, p, kind: str, ctx):
    """x_full (B, S, D) -> tp-partial (B, S, D); the caller reduces (and
    adds the replicated gelu bias b2 after the reduction)."""
    w1 = ctx.weight_gather(p["w1"], 0)
    w2 = ctx.weight_gather(p["w2"], 1)
    if kind in ("swiglu", "geglu"):
        w3 = ctx.weight_gather(p["w3"], 0)
        h = x_full @ w1
        g = x_full @ w3
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(h) if kind == "swiglu" else F.gelu(h, approximate="tanh")
        return (act * g) @ w2
    h = x_full @ w1 + p["b1"].to(x_full.dtype)
    return F.gelu(h, approximate="tanh") @ w2


# --------------------------------------------------------------------------
# vocab-parallel embedding + LM head
# --------------------------------------------------------------------------

def embed_specs(pb: ParamBuilder, vocab_pad: int, d: int, tie: bool):
    pb.add("embed.table", (vocab_pad, d), fsdp_dim=1, tp_dim=0, scale=0.02)
    if not tie:
        pb.add("head.table", (vocab_pad, d), fsdp_dim=1, tp_dim=0, scale=0.02)


def embed_partial(tokens, table_local, ctx):
    """Vocab-parallel lookup -> tp-partial (B, S, D) (pre-reduction)."""
    table = ctx.weight_gather(table_local, 1)
    v_loc = table.shape[0]
    shifted = tokens.long() - ctx.tp_rank * v_loc
    valid = (shifted >= 0) & (shifted < v_loc)
    part = table[shifted.clamp(0, v_loc - 1)]
    return torch.where(valid[..., None], part,
                       torch.zeros((), dtype=part.dtype,
                                   device=part.device)).to(COMPUTE_DTYPE)


def vocab_parallel_xent(x_full, table_local, labels, mask, ctx, plan,
                        chunk: int = 512):
    """x_full (B, S, D), labels (B, S), mask (B, S) -> (sum_loss, count),
    local f32 scalars.

    Logits are computed per vocab shard in sequence chunks of ``chunk``
    tokens, each under ``torch.utils.checkpoint``, so one chunk's (B,
    chunk, V/tp) f32 logits are live at a time, in the forward and in the
    backward.  The softmax statistics are combined over the group with
    ``psum_exact`` (O(B*S) scalars, left uncompressed as in the paper),
    after the shift by the group max of the logits."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core.collectives import pmax, psum_exact
    table = ctx.weight_gather(table_local, 1)                # (V/tp, D)
    v_loc = table.shape[0]
    s = x_full.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s

    def chunk_loss(xc, yc, mc):
        logits = (xc @ table.T).float()                      # (B, c, V/tp)
        # numerical-stability shift only: no gradient flows through it;
        # the group max, so that every rank shifts by the same value
        m = pmax(logits.detach().amax(dim=-1), ctx.comm)
        z = psum_exact(torch.exp(logits - m[..., None]).sum(dim=-1),
                       ctx.comm)
        shifted = yc.long() - ctx.tp_rank * v_loc
        valid = (shifted >= 0) & (shifted < v_loc)
        picked = torch.gather(logits, -1,
                              shifted.clamp(0, v_loc - 1)[..., None])[..., 0]
        label_logit = psum_exact(torch.where(valid, picked, 0.0),
                                 ctx.comm)
        nll = (torch.log(z) + m) - label_logit
        return (nll * mc).sum(), mc.sum()

    loss = torch.zeros((), dtype=torch.float32, device=x_full.device)
    count = torch.zeros((), dtype=torch.float32, device=x_full.device)
    for i in range(0, s, chunk):
        l, c = checkpoint(chunk_loss, x_full[:, i:i + chunk],
                          labels[:, i:i + chunk],
                          mask[:, i:i + chunk].float(), use_reentrant=False)
        loss = loss + l
        count = count + c
    return loss, count


def lm_head_logits(x, table_local, ctx):
    """Decode-path local logits (B, 1, V/tp) in f32."""
    table = ctx.weight_gather(table_local, 1)
    return (x @ table.T).float()


def distributed_argmax(logits, ctx, vocab: int):
    """logits (B, 1, V/tp) -> global argmax token ids (B, 1).  Each rank's
    shard maximum and its global id are gathered over the group; the first
    maximum wins, across shards as inside one (``jnp.argmax``).  Ids at or
    past ``vocab`` (the rows that pad the head to a multiple of 128) never
    win: the JAX package's argmax lets them, and a served model then emits
    a token outside its vocabulary."""
    from repro_torch.core.collectives import all_gather_stack
    v_loc = logits.shape[-1]
    ids = ctx.tp_rank * v_loc + torch.arange(v_loc, device=logits.device)
    logits = logits.masked_fill(ids >= vocab, float("-inf"))
    local_val = logits.amax(dim=-1)                         # (B, 1)
    local_arg = torch.argmax(logits, dim=-1) + ctx.tp_rank * v_loc
    vals = all_gather_stack(local_val, ctx.comm)            # (tp, B, 1)
    args = all_gather_stack(local_arg, ctx.comm)
    best = torch.argmax(vals, dim=0)                        # first max
    return torch.gather(args, 0, best[None])[0]
