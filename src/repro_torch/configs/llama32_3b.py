"""Config module for LLAMA32_3B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import LLAMA32_3B as CONFIG

__all__ = ["CONFIG"]
