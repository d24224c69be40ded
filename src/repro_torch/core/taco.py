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
from typing import Literal

import torch

from repro_torch.core import quant as quant_mod

__all__ = ["TacoConfig", "wire_components"]

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


def _storage_to_wire(q: torch.Tensor,
                     fmt: quant_mod.FormatSpec) -> torch.Tensor:
    return q.view(torch.uint8) if fmt.is_float else q


def _wire_to_storage(p: torch.Tensor,
                     fmt: quant_mod.FormatSpec) -> torch.Tensor:
    return p.view(fmt.dtype) if fmt.is_float else p


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
