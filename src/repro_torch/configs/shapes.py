"""The input-shape suites of the dry run (four shape cells per
architecture): a copy of the JAX package's ``configs/shapes.py`` (pure
Python; the port imports nothing of ``repro``).

``decode_*`` / ``long_*`` cells decode one new token against a KV / state
cache of ``seq_len``; the others are training steps.  ``long_500k`` needs
sub-quadratic attention and is skipped for the archs of pure full
attention (recorded, not run).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

__all__ = ["ShapeSuite", "SHAPES", "applicable", "cells"]


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "decode"


SHAPES: dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32768, 32, "train"),
    "decode_32k": ShapeSuite("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runs?, the reason when skipped): ``long_500k`` only for
    sub-quadratic archs; every assigned arch is a decoder or an
    encoder-decoder, so decode runs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: O(S^2) at 512k infeasible (DESIGN.md §4)"
    return True, ""


def cells(cfg: ArchConfig) -> list[tuple[str, bool, str]]:
    return [(name,) + applicable(cfg, name) for name in SHAPES]
