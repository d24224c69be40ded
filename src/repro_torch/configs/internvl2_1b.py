"""Config module for INTERNVL2_1B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import INTERNVL2_1B as CONFIG

__all__ = ["CONFIG"]
