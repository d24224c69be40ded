"""Config module for QWEN25_7B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import QWEN25_7B as CONFIG

__all__ = ["CONFIG"]
