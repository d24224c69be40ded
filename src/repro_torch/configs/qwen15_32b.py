"""Config module for QWEN15_32B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import QWEN15_32B as CONFIG

__all__ = ["CONFIG"]
