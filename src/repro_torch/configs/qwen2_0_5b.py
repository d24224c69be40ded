"""Config module for QWEN2_0_5B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import QWEN2_0_5B as CONFIG

__all__ = ["CONFIG"]
