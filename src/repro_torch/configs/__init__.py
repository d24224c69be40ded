"""Config registry: copies of the JAX package's ``configs/base.py`` and
``configs/archs.py`` (pure Python; the port imports nothing of ``repro``).
Importing this package registers every architecture."""
from repro_torch.configs import archs as _archs  # noqa: F401  (registration)
from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.base import (ArchConfig, MoeConfig, RunPlan,
                                      SsmConfig, get_config, list_configs,
                                      make_plan, smoke_config)

__all__ = [
    "ArchConfig", "MoeConfig", "SsmConfig", "RunPlan", "make_plan",
    "get_config", "list_configs", "smoke_config", "ASSIGNED",
]
