"""Adaptive Scale-Hadamard (ASH) transform — paper §4.2.

Blocks of size B are rescaled so their RMS energy hits a target tau, then
rotated by the orthogonal Walsh-Hadamard matrix H_B/sqrt(B).  Two
equivalent rotations, as in the JAX package:

  * ``hadamard_matrix`` + matmul — the plain (oracle) form;
  * ``fwht`` — the O(B log B) butterfly, which is also the order the CUDA
    kernels (``repro_torch/kernels/csrc``) rotate in.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "hadamard_matrix",
    "fwht",
    "block_partition",
    "block_unpartition",
    "ash_forward",
    "ash_inverse",
]


@functools.lru_cache(maxsize=16)
def _hadamard_np(block_size: int) -> np.ndarray:
    """Sylvester-construction Hadamard matrix (entries +-1), cached."""
    if block_size <= 0 or (block_size & (block_size - 1)) != 0:
        raise ValueError(f"block_size must be a power of 2, got {block_size}")
    h = np.array([[1.0]], dtype=np.float64)
    base = np.array([[1.0, 1.0], [1.0, -1.0]], dtype=np.float64)
    while h.shape[0] < block_size:
        h = np.kron(h, base)
    return h


def hadamard_matrix(block_size: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Normalized (orthogonal) Hadamard matrix H_B / sqrt(B)."""
    h = _hadamard_np(block_size) / np.sqrt(block_size)
    return torch.as_tensor(h, dtype=dtype, device=device)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (unnormalized):
    ``x @ hadamard_matrix(B) * sqrt(B)``."""
    n = x.shape[-1]
    if n & (n - 1) != 0:
        raise ValueError(f"last dim must be a power of 2, got {n}")
    lead = x.shape[:-1]
    x = x.reshape(-1, n)
    h = 1
    while h < n:
        x = x.reshape(-1, n // (2 * h), 2, h)
        a, b = x[:, :, 0, :], x[:, :, 1, :]
        x = torch.cat([a + b, a - b], dim=-1)
        h *= 2
    return x.reshape(*lead, n)


def block_partition(x: torch.Tensor,
                    block_size: int) -> tuple[torch.Tensor, int]:
    """Flatten ``x`` and partition into (M, B) blocks, zero-padding the tail.
    Returns (blocks, orig_size)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    rem = (-n) % block_size
    if rem:
        flat = torch.nn.functional.pad(flat, (0, rem))
    return flat.reshape(-1, block_size), n


def block_unpartition(blocks: torch.Tensor, orig_size: int,
                      shape) -> torch.Tensor:
    return blocks.reshape(-1)[:orig_size].reshape(shape)


def _rotate(z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Rotation ``z @ h``.  An f32 rotation accumulates in f64 and rounds
    once: the products of f32 values with the +-2^-k entries of H/sqrt(B)
    are exact in f64, so a row's result no longer depends on how the BLAS
    tiles the rows of the call — a chunked ring hop and the monolithic hop
    then rotate each row bit for bit alike (an f32 matmul of 3 rows and of
    1 row differ in the last bit on the CPU).  On the card the oracle must
    not run in TF32 (about ten mantissa bits), so both TF32 switches are
    set off here."""
    if z.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if z.dtype == torch.float32:
        return (z.double() @ h.double()).float()
    return z @ h


def ash_forward(blocks: torch.Tensor, *, tau: float = 1.0, eps: float = 1e-12,
                compute_dtype=torch.float32):
    """Paper Eq. 6-8: blocks (M, B) -> (Z, alpha).

    sigma_k = sqrt(mean(G_k^2) + eps);  alpha_k = tau / sigma_k
    Z_k = (alpha_k * G_k) @ (H_B / sqrt(B))
    """
    b = blocks.shape[-1]
    g = blocks.to(compute_dtype)
    sigma = torch.sqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    alpha = tau / sigma
    h = hadamard_matrix(b, compute_dtype, g.device)
    z = _rotate(alpha * g, h)
    return z, alpha[..., 0]


def ash_inverse(z: torch.Tensor, alpha: torch.Tensor, *,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Paper Eq. 12-13: inverse rotation then undo the adaptive rescale."""
    b = z.shape[-1]
    h = hadamard_matrix(b, compute_dtype, z.device)
    return _rotate(z.to(compute_dtype), h) / alpha[..., None]
