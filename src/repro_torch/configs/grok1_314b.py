"""Config module for GROK1_314B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import GROK1_314B as CONFIG

__all__ = ["CONFIG"]
