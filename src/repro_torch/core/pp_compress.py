"""TahQuant-style fine-grained int8 quantization for the pipeline boundary
path (paper §2.2, §5.5: the PP sends are quantized with TahQuant while
TACO handles TP) and for the fsdp weight gather (``weight_ag=int8``) —
the JAX package's ``repro/core/pp_compress.py`` in PyTorch.

Per-group symmetric int8 with one f32 scale a group, floored at 1e-30; no
rotation.  The scale is the group's ``max|z|`` times the f32 constant
``1/127``: the JAX package writes ``max|z| / 127``, and XLA compiles a
division by a constant into that multiplication (in every jitted program,
so in every training step; only an op-by-op call divides), which rounds
some scales one bit apart from a true division.  ``z / s`` is a true f32
division, as in the compiled reference, and rounding is half to even
(``torch.round``, as ``jnp.round``), so both packages emit the same codes
and the same scales on the same input.  Plain PyTorch on either device:
the JAX package computes these in ``jnp``, outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

INT8_MAX = 127.0
#: 1/127 rounded to f32, the constant XLA multiplies by for ``/ 127``
INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))
SCALE_FLOOR = 1e-30


def compress_int8_group(x: torch.Tensor, group: int):
    """x (..., n) with n % group == 0 -> (q int8 (..., n), s f32
    (..., n/group))."""
    lead, n = x.shape[:-1], x.shape[-1]
    z = x.float().reshape(*lead, n // group, group)
    s = torch.clamp_min(z.abs().amax(dim=-1) * INV_INT8_MAX, SCALE_FLOOR)
    q = torch.clamp(torch.round(z / s[..., None]), -INT8_MAX,
                    INT8_MAX).to(torch.int8)
    return q.reshape(*lead, n), s.reshape(*lead, n // group)


def decompress_int8_group(q, s, n: int, group: int, dtype):
    """Inverse of :func:`compress_int8_group` -> (..., n) in ``dtype``."""
    lead = q.shape[:-1]
    z = q.float().reshape(*lead, n // group, group)
    z = z * s.reshape(*lead, n // group, 1)
    return z.reshape(*lead, n).to(dtype)


def decompress_sum_int8_group(q, s, n: int, group: int, dtype):
    """q (P, ..., n) -> the decoded sum over the P peers, in peer order,
    in f32, cast once to ``dtype``."""
    p, lead = q.shape[0], q.shape[1:-1]
    terms = q.float().reshape(p, *lead, n // group, group) * \
        s.reshape(p, *lead, n // group, 1)
    z = terms[0]
    for j in range(1, p):
        z = z + terms[j]
    return z.reshape(*lead, n).to(dtype)
