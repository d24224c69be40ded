"""Low-bit formats and Dual-Scale quantization — paper §3, §4.3.

The same format table as the JAX package, mapped to torch storage dtypes:
FP8 E4M3 (Q_max 448), FP8 E5M2 (Q_max 57344) and INT8 (Q_max 127).
A per-group scale s = max|Z|/Q_max maps each rotated group into the
representable range; ``group_size`` may be finer than the ASH block.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["FORMATS", "FormatName", "FormatSpec", "get_format",
           "int8_codes", "quantize_ds", "dequantize_ds"]

FormatName = Literal["e4m3", "e5m2", "int8"]


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    name: str
    dtype: torch.dtype     # storage dtype (fp8 variants) or int8
    qmax: float            # largest representable magnitude
    is_float: bool

    @property
    def wire_dtype(self) -> torch.dtype:
        """dtype actually placed on the wire (uint8 bits for fp8)."""
        return torch.uint8 if self.is_float else torch.int8


FORMATS: dict[str, FormatSpec] = {
    "int8": FormatSpec("int8", torch.int8, 127.0, False),
    "e4m3": FormatSpec("e4m3", torch.float8_e4m3fn, 448.0, True),
    "e5m2": FormatSpec("e5m2", torch.float8_e5m2, 57344.0, True),
}


def get_format(name: str) -> FormatSpec:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown low-bit format {name!r}; "
                         f"known: {sorted(FORMATS)}") from None


def _group(z: torch.Tensor, group_size: int) -> torch.Tensor:
    m, b = z.shape
    if b % group_size:
        raise ValueError(f"group_size {group_size} must divide block {b}")
    return z.reshape(m, b // group_size, group_size)


def int8_codes(scaled: torch.Tensor) -> torch.Tensor:
    """Clipped quotients -> int8 codes, rounded half to even like
    ``jnp.round``; NaN gives 0, as the JAX package's cast and the kernels'
    ``__float2int_rn`` give it (a float NaN's conversion to int8 is not
    defined in C++: x86 gives 0 only through its INT_MIN's low byte)."""
    return torch.round(torch.where(scaled.isnan(), 0.0, scaled)).to(
        torch.int8)


def quantize_ds(z: torch.Tensor, fmt: FormatSpec, *,
                group_size: int | None = None,
                eps: float = 1e-30) -> tuple[torch.Tensor, torch.Tensor]:
    """Dual-scale quantize rotated blocks ``z`` (M, B) -> (q, s).

    s has shape (M, B/group); q keeps the (M, B) layout in the format's
    storage dtype.  Values are clipped to ±Q_max before the cast, so the
    fp8 cast never saturates; int8 rounds half to even like ``jnp.round``.
    """
    m, b = z.shape
    zg = _group(z, group_size or b)
    s = zg.abs().amax(dim=-1) / fmt.qmax
    s = torch.clamp_min(s, eps)
    scaled = torch.clamp(zg / s[..., None], -fmt.qmax, fmt.qmax)
    q = scaled.to(fmt.dtype) if fmt.is_float else int8_codes(scaled)
    return q.reshape(m, b), s


def dequantize_ds(q: torch.Tensor, s: torch.Tensor, fmt: FormatSpec, *,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of quantize_ds: (M, B) payload + (M, B/gs) scales -> z_hat."""
    m, b = q.shape
    groups = s.shape[-1]
    zg = q.to(compute_dtype).reshape(m, groups, b // groups)
    return (zg * s[..., None].to(compute_dtype)).reshape(m, b)
