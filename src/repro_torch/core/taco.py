"""TACO configuration and wire format — paper §4 (Algorithm 1).

A tensor is cut into (M, B) blocks -> [adaptive rescale] -> [Hadamard
rotation] -> dual-scale low-bit quantize -> wire payload + per-block
metadata (``TacoCodec`` in ``core/codecs.py`` runs the steps).

Metadata modes:
  * ``dual``   — transmit (alpha_k, s_k) per block, as Alg. 1.
  * ``folded`` — transmit the single ratio s_k/alpha_k (alpha cancels at
    block-or-finer granularity), halving the metadata bytes.

Unlike the JAX package, the implementation is chosen by the device of the
tensor (``repro_torch.kernels.ops``), not by a global backend, so
``impl`` only accepts ``"auto"``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import torch

from repro_torch.core import ash as ash_mod
from repro_torch.core import quant as quant_mod

__all__ = ["TacoConfig", "Compressed", "compress", "decompress",
           "wire_components", "wire_bytes", "raw_bytes"]

#: ``TacoConfig.compute_dtype`` names and the torch dtypes they denote.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TacoConfig:
    """Static compression configuration (hashable; same fields and
    defaults as the JAX package's ``TacoConfig``)."""

    enabled: bool = True
    block_size: int = 256
    fmt: str = "e4m3"                     # e4m3 | e5m2 | int8
    tau: float = 1.0
    eps: float = 1e-12
    # floor on the dual-scale s keeping all-zero / denormal blocks away
    # from 0/0; one value routed through the CUDA kernels and the plain
    # versions alike
    scale_eps: float = 1e-30
    transform: Literal["ash", "hadamard", "none"] = "ash"
    scale_granularity: Literal["block", "tensor"] = "block"
    quant_group_size: int | None = None   # finer-than-block s granularity
    metadata: Literal["dual", "folded"] = "dual"
    impl: Literal["auto"] = "auto"
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r} not one "
                             f"of {sorted(_DTYPES)}")
        if self.impl != "auto":
            raise ValueError(
                f"impl {self.impl!r} is a TPU implementation token; the "
                "port picks the CUDA kernel or the plain version by the "
                "tensor's device (impl='auto')")
        if self.scale_granularity == "tensor" and \
                self.quant_group_size is not None:
            raise ValueError(
                "scale_granularity='tensor' and quant_group_size are "
                "mutually exclusive")

    @property
    def format_spec(self) -> quant_mod.FormatSpec:
        return quant_mod.get_format(self.fmt)

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


class Compressed(NamedTuple):
    """Wire representation. ``alpha`` is None in folded-metadata mode."""

    payload: torch.Tensor         # (M, B) wire dtype (uint8 bits of fp8 / int8)
    scale: torch.Tensor           # (M, groups) f32: s_k (dual) or s_k/alpha_k
    alpha: torch.Tensor | None    # (M,) f32, dual mode only


def _storage_to_wire(q: torch.Tensor,
                     fmt: quant_mod.FormatSpec) -> torch.Tensor:
    return q.view(torch.uint8) if fmt.is_float else q


def _wire_to_storage(p: torch.Tensor,
                     fmt: quant_mod.FormatSpec) -> torch.Tensor:
    return p.view(fmt.dtype) if fmt.is_float else p


def compress(x: torch.Tensor, cfg: TacoConfig) -> Compressed:
    """Alg. 1 sender side on a local tensor of any shape: the compress
    operator of ``repro_torch.kernels.ops`` (K1 on a CUDA tensor)."""
    from repro_torch.kernels import ops  # the kernels layer sits above core

    blocks, _ = ash_mod.block_partition(x, cfg.block_size)
    q, alpha, s = ops.compress_blocks(blocks, cfg)
    payload = _storage_to_wire(q, cfg.format_spec)
    if cfg.metadata == "folded":
        return Compressed(payload, s / alpha[:, None], None)
    return Compressed(payload, s, alpha)


def decompress(c: Compressed, cfg: TacoConfig, *, shape,
               dtype) -> torch.Tensor:
    """Alg. 1 receiver side -> tensor of ``shape`` / ``dtype`` (K3 on a
    CUDA tensor)."""
    from repro_torch.kernels import ops

    q = _wire_to_storage(c.payload, cfg.format_spec)
    alpha = None if cfg.metadata == "folded" else c.alpha
    blocks = ops.decompress_blocks(q, c.scale, alpha, cfg)
    size = 1
    for d in shape:
        size *= d
    return ash_mod.block_unpartition(blocks, size, shape).to(dtype)


def wire_components(cfg: TacoConfig, n: int) -> tuple:
    """Static wire format of one ``n``-element slot (``n`` a multiple of
    ``cfg.block_size``): ``(name, dtype_name, elems_per_slot)`` triples in
    ``TacoCodec.encode`` output order — the byte-layout contract shared
    with the JAX package."""
    b = cfg.block_size
    if n % b:
        raise ValueError(f"slot size {n} not a multiple of block {b}")
    mb = n // b
    groups = b // (cfg.quant_group_size or b)
    payload_dtype = "uint8" if cfg.format_spec.is_float else "int8"
    comps = [("payload", payload_dtype, n), ("scale", "float32", mb * groups)]
    if cfg.metadata != "folded":
        comps.append(("alpha", "float32", mb))
    return tuple(comps)


def wire_bytes(c: Compressed) -> int:
    """Bytes actually transmitted for a Compressed value (static)."""
    total = c.payload.numel() * c.payload.element_size()
    total += c.scale.numel() * c.scale.element_size()
    if c.alpha is not None:
        total += c.alpha.numel() * c.alpha.element_size()
    return total


def raw_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()
