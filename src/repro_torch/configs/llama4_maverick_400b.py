"""Config module for LLAMA4_MAVERICK (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import LLAMA4_MAVERICK as CONFIG

__all__ = ["CONFIG"]
