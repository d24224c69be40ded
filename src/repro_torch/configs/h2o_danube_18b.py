"""Config module for H2O_DANUBE_18B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import H2O_DANUBE_18B as CONFIG

__all__ = ["CONFIG"]
