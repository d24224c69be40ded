"""Config module for HYMBA_15B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import HYMBA_15B as CONFIG

__all__ = ["CONFIG"]
