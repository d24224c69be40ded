"""What the benchmark hands to both sides: the weights and the token
batches, each a function of ``--seed``.

The weight tree is laid out from the configuration file alone, in the
nesting the program takes (a dict per module, the layers of each run of
one attention kind stacked on a leading dim), and the program's own
parameter shapes are checked against it before a step runs.  Each leaf is
drawn on the device in one call from a generator of its own, so the
check can draw any leaf again instead of keeping a copy: normals (bf16,
times the leaf's scale), or zeros and ones where the layer starts so.

A batch is ``(B, S + 1)`` token ids drawn uniformly from the vocabulary
on the device, split into tokens and next-token labels; the generator of
step ``i`` is seeded from ``(seed, i)``, so every step's rows differ and
the same seed gives the same batches.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from perfbench.reference import model
from perfbench.reference.train import like_tree, named_leaves

#: rows of the learned position table (the program's; more than any cell's
#: sequence)
POS_ROWS = 8192


def _seed(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any size."""
    ss = np.random.SeedSequence([int(p) % (1 << 64) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def vocab_rows(cfg) -> int:
    """The embedding's and head's rows: the vocabulary padded to 128."""
    return -(-cfg["vocab_size"] // 128) * 128


@dataclasses.dataclass(frozen=True)
class Leaf:
    """How one weight leaf starts: its shape, ``"normal"`` (times
    ``scale``), ``"zeros"`` or ``"ones"``."""
    shape: tuple
    init: str = "normal"
    scale: float = 0.02


def layer_layout(cfg) -> dict:
    """One layer's leaves."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    q, kv, f = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd, cfg["d_ff"]

    def zeros(*shape):
        return Leaf(shape, "zeros", 0.0)

    def norm_leaves():
        out = {"scale": zeros(d)}
        if cfg["norm"] == "layernorm":
            out["bias"] = zeros(d)
        return out
    attn = {"wq": Leaf((d, q)), "wk": Leaf((d, kv)), "wv": Leaf((d, kv)),
            "wo": Leaf((q, d))}
    if cfg["qkv_bias"]:
        attn.update(bq=zeros(q), bk=zeros(kv), bv=zeros(kv))
    if cfg["mlp"] == "gelu":
        mlp = {"w1": Leaf((d, f)), "b1": zeros(f), "b2": zeros(d),
               "w2": Leaf((f, d))}
    else:
        mlp = {"w1": Leaf((d, f)), "w3": Leaf((d, f)), "w2": Leaf((f, d))}
    out = {"norm1": norm_leaves(), "norm2": norm_leaves(), "attn": attn,
           "mlp": mlp}
    return out


def layout(cfg) -> dict:
    """The whole weight tree of :class:`Leaf`."""
    d, v = cfg["d_model"], vocab_rows(cfg)
    tree = {"embed": {"table": Leaf((v, d))},
            "final_norm": {"scale": Leaf((d,), "zeros", 0.0)}}
    if cfg["norm"] == "layernorm":
        tree["final_norm"]["bias"] = Leaf((d,), "zeros", 0.0)
    if not cfg["tie_embeddings"]:
        tree["head"] = {"table": Leaf((v, d))}
    if cfg["pos"] == "learned":
        tree["pos_embed"] = Leaf((POS_ROWS, d), scale=0.01)

    def stack(t, n):
        if isinstance(t, dict):
            return {k: stack(x, n) for k, x in t.items()}
        return dataclasses.replace(t, shape=(n,) + t.shape)
    one = layer_layout(cfg)
    tree["segments"] = [stack(one, n) for _, n in model.segments(cfg)]
    return tree


def draw_leaf(leaf: Leaf, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` of the tree drawn from ``seed`` in bf16."""
    if leaf.init != "normal":
        fill = torch.zeros if leaf.init == "zeros" else torch.ones
        return fill(leaf.shape, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 1, index))
    return torch.randn(leaf.shape, generator=gen, dtype=torch.bfloat16,
                       device=device).mul_(leaf.scale)


def weights(cfg, seed: int, device) -> dict:
    """The weight tree drawn from ``seed`` on ``device``."""
    tree = layout(cfg)
    return like_tree(tree, [draw_leaf(leaf, seed, i, device)
                            for i, (_, leaf) in enumerate(named_leaves(tree))])


def initial_leaf(cfg, seed: int, device):
    """``i -> `` leaf i as :func:`weights` draws it."""
    leaves = [leaf for _, leaf in named_leaves(layout(cfg))]
    return lambda i: draw_leaf(leaves[i], seed, i, device)


def shapes(tree) -> dict:
    """Leaf name -> shape of a tree of tensors."""
    return {name: tuple(t.shape) for name, t in named_leaves(tree)}


class Batches:
    """The data object the trainer reads: ``batch(step)`` on the device,
    ``place`` a no-op move.  ``spans`` (a ``tracing.Spans`` or None)
    records the time of each call."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int, device,
                 spans=None):
        self.seed, self.shape, self.vocab = seed, (batch, seq + 1), vocab
        self.device, self.spans = torch.device(device), spans

    def batch(self, step: int) -> dict:
        with self._span():
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_seed(self.seed, 2, step))
            toks = torch.randint(0, self.vocab, self.shape, generator=gen,
                                 device=self.device)
            b, s = self.shape[0], self.shape[1] - 1
            return {"tokens": toks[:, :-1].contiguous(),
                    "labels": toks[:, 1:].contiguous(),
                    "mask": torch.ones((b, s), dtype=torch.float32,
                                       device=self.device)}

    def place(self, batch: dict, device) -> dict:
        with self._span():
            return {k: v.to(device, non_blocking=True)
                    for k, v in batch.items()}

    def _span(self):
        return self.spans.span("data") if self.spans is not None \
            else contextlib.nullcontext()
