"""Dispatch of the TACO operators by the device of the tensor.

A CPU tensor takes the plain PyTorch version (``ref``); a CUDA tensor
takes the hand-written kernel or raises.  The fused wire forms are the
kernel wrappers themselves (each dispatches on its input).  The block
forms — the TPU kernels ``compress_blocks_pallas``,
``decompress_blocks_pallas`` and ``decompress_reduce_pallas`` — have no
CUDA kernel yet (the training-hop slice ports them), so on the card they
raise rather than run the plain version in a kernel's place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ash_compress import compress_wire  # noqa: F401
from repro_torch.kernels.ash_decompress import (  # noqa: F401
    decompress_reduce_wire, decompress_wire)


def _cpu_only(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{name} has no CUDA kernel yet (ported with the training hop); "
            f"got a tensor on {t.device}")


def compress_blocks(blocks: torch.Tensor, cfg):
    """(M, B) -> (q storage dtype, alpha (M,), s (M,G))."""
    _cpu_only(blocks, "compress_blocks")
    return ref.compress_blocks_ref(blocks, cfg)


def decompress_blocks(q: torch.Tensor, s: torch.Tensor, alpha, cfg):
    """(q, s, alpha|None) -> blocks (M, B) in cfg.compute_dtype."""
    _cpu_only(q, "decompress_blocks")
    return ref.decompress_blocks_ref(q, s, alpha, cfg).to(
        cfg.torch_compute_dtype)


def decompress_reduce(q: torch.Tensor, s: torch.Tensor, alpha, cfg):
    """Stacked peers q (P,M,B) -> summed blocks (M,B): the rotated-domain
    sum with ONE inverse rotation, the same arithmetic as the JAX
    package's jnp path."""
    _cpu_only(q, "decompress_reduce")
    from repro_torch.core import ash as ash_mod
    peers, m, b = q.shape
    groups = s.shape[-1]
    cd = cfg.torch_compute_dtype
    f = s if alpha is None else s / alpha[..., None]            # (P, M, G)
    zsum = torch.einsum(
        "pmgk,pmg->mgk",
        q.reshape(peers, m, groups, b // groups).to(cd), f.to(cd),
    ).reshape(m, b)
    if cfg.transform in ("ash", "hadamard"):
        zsum = ash_mod._rotate(zsum, ash_mod.hadamard_matrix(b, cd,
                                                             zsum.device))
    return zsum
