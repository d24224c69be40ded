"""The TACO round trip of one TP hop, in plain PyTorch.

A frozen copy of the port's plain compress and decompress at the plan the
cells run (``src/repro_torch/kernels/ref.py`` ``_compress_blocks_f32``
and ``decompress_blocks_ref``; ``core/ash.py``, ``core/quant.py``): the
hop's tensor is flattened in the order the hop lays it out, cut into
blocks of ``block`` elements, and each block goes through the adaptive
rescale (alpha = tau / rms), the orthogonal Hadamard rotation (in f64,
rounded once) and the dual-scale cast to FP8 (one scale a block); the
receiver multiplies the codes back by the scale, rotates back and divides
by alpha.  Nothing here imports the program.

:class:`Hop` is the hop as the training step sees it: the round trip on
the way forward, and on the cotangent on the way back, each in the order
its collective lays the tensor out (the Megatron-SP all-gather flattens
``(B, S, D)`` as it is, its reduce-scatter with the sequence dim first),
its output in the arithmetic's activation precision (f32, or e4m3 for
the lower-precision control).

:class:`Tap` keeps three hops of one training step, so that the check can
hold a side's hops, input against output and input against input.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

#: storage dtype and largest magnitude of each payload format
FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0),
           "e5m2": (torch.float8_e5m2, 57344.0)}


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform along the last axis (a
    power of two), by the butterfly."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    x = x.reshape(-1, n)
    h = 1
    while h < n:
        x = x.reshape(-1, n // (2 * h), 2, h)
        a, b = x[:, :, 0, :], x[:, :, 1, :]
        x = torch.cat([a + b, a - b], dim=-1)
        h *= 2
    return x.reshape(*lead, n)


@functools.lru_cache(maxsize=4)
def _hadamard_np(b: int) -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < b:
        h = np.kron(h, np.array([[1.0, 1.0], [1.0, -1.0]]))
    return h / np.sqrt(b)


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a tree of adjacent pairs."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def compress(blocks: torch.Tensor, codec: dict):
    """(M, B) -> (codes (M, B) fp8, alpha (M,) f32, s (M,) f32)."""
    dtype, qmax = FORMATS[codec["fmt"]]
    b = blocks.shape[-1]
    g = blocks.float()
    sigma = torch.sqrt((pairwise_sum(g * g) / b + codec["eps"]).double()
                       ).float()
    alpha = torch.div(torch.tensor(codec["tau"], dtype=torch.float32,
                                   device=g.device), sigma)
    z = (fwht((alpha[:, None] * g).double()) * (1.0 / np.sqrt(b))).float()
    qm = torch.tensor(qmax, dtype=torch.float32, device=g.device)
    s = torch.clamp_min(z.abs().amax(dim=-1) / qm, codec["scale_eps"])
    q = torch.clamp(z / s[:, None], -qmax, qmax).to(dtype)
    return q, alpha, s


def decompress(q: torch.Tensor, alpha: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compress` -> (M, B) f32."""
    z = q.float() * s[:, None]
    h = torch.as_tensor(_hadamard_np(q.shape[-1]), dtype=torch.float64,
                        device=q.device)
    return (z.double() @ h).float() / alpha[:, None]


def fp8_round(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to e4m3 at one scale (amax / 448), back in f32."""
    s = a.abs().amax().clamp_min(1e-30) / 448.0
    return (a / s).to(torch.float8_e4m3fn).float() * s


def _carried(t: torch.Tensor, prec: str) -> torch.Tensor:
    """A hop's output as the arithmetic ``prec`` carries it."""
    return fp8_round(t) if prec == "fp8" else t


def round_trip(x: torch.Tensor, codec: dict, first: int | None,
               rows: int = 1 << 17) -> torch.Tensor:
    """``x`` through compress and decompress, flattened as it is or, for a
    reduce-scatter, with dim ``first`` moved to the front; f32 out, in
    ``x``'s layout.  The blocks are taken ``rows`` at a time, so the f64
    temporaries stay small."""
    if codec["kind"] == "identity":
        return x
    t = x if first is None else torch.movedim(x, first, 0)
    flat = t.reshape(-1)
    b = codec["block"]
    pad = (-flat.numel()) % b
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, b)
    out = torch.empty(blocks.shape, dtype=torch.float32, device=x.device)
    for lo in range(0, blocks.shape[0], rows):
        part = blocks[lo:lo + rows]
        out[lo:lo + rows] = decompress(*compress(part, codec))
    out = out.reshape(-1)[:flat.numel()].reshape(t.shape)
    return out if first is None else torch.movedim(out, 0, first)


class Tap:
    """Three TP hops of one training step, each ``(input, output,
    first)`` (``first`` as :func:`round_trip` takes it): the forward's
    last (the final norm's entry), the backward's first (its cotangent)
    and the step's last (the embedding's cotangent)."""

    NAMES = ("forward_last", "backward_first", "backward_last")

    def __init__(self):
        self.kept, self.latest = {}, None

    def hop(self, x, y, first, backward: bool) -> None:
        """One hop as a side runs it, ``backward`` when it runs inside the
        backward pass (a recompute's forward hops too)."""
        rec = (x, y, first)
        if "backward_first" not in self.kept and backward:
            self.kept["forward_last"] = self._keep(self.latest)
            self.kept["backward_first"] = self._keep(rec)
            rec = None
        self.latest = rec

    def records(self) -> dict:
        """``{name: (input, output, first)}`` of the hops seen."""
        out = dict(self.kept)
        if "backward_first" in out and self.latest is not None:
            out["backward_last"] = self._keep(self.latest)
        return out

    @staticmethod
    def _keep(rec):
        return None if rec is None else \
            (rec[0].detach(), rec[1].detach(), rec[2])


#: the tap of the step being recorded, or None
TAP: Tap | None = None


class Hop(torch.autograd.Function):
    """One TP hop: the round trip forward in one layout, and on the
    cotangent in the other (an all-gather's backward is a reduce-scatter,
    and back)."""

    @staticmethod
    def forward(ctx, x, codec, seq_first, prec):
        ctx.codec, ctx.seq_first, ctx.prec = codec, seq_first, prec
        first = 1 if seq_first else None
        out = _carried(round_trip(x, codec, first), prec)
        if TAP is not None:
            TAP.hop(x, out, first,
                    torch._C._current_autograd_node() is not None)
        return out

    @staticmethod
    def backward(ctx, ct):
        first = None if ctx.seq_first else 1
        ct = ct.contiguous()
        out = _carried(round_trip(ct, ctx.codec, first), ctx.prec)
        if TAP is not None:
            TAP.hop(ct, out, first, True)
        return out, None, None, None


def enter(x, codec, prec="f32"):
    """The block's entry (an all-gather of the residual stream)."""
    return Hop.apply(x, codec, False, prec)


def leave(x, codec, prec="f32"):
    """The block's exit (a reduce-scatter of its partial output)."""
    return Hop.apply(x, codec, True, prec)
