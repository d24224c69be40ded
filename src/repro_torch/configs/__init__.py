"""Config registry: copies of the JAX package's ``configs/base.py``,
``configs/archs.py``, ``configs/shapes.py`` and its per-arch modules
(``configs/qwen2_0_5b.py`` and its siblings, each a ``CONFIG``); pure
Python, the port imports nothing of ``repro``.  Importing this package
registers every architecture."""
from repro_torch.configs import archs as _archs  # noqa: F401  (registration)
from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.base import (ArchConfig, MoeConfig, RunPlan,
                                      SsmConfig, get_config, list_configs,
                                      make_plan, smoke_config)
from repro_torch.configs.shapes import SHAPES, ShapeSuite, applicable, cells

__all__ = [
    "ArchConfig", "MoeConfig", "SsmConfig", "RunPlan", "make_plan",
    "get_config", "list_configs", "smoke_config", "ASSIGNED",
    "SHAPES", "ShapeSuite", "applicable", "cells",
]
