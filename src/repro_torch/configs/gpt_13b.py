"""Config module for GPT_13B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import GPT_13B as CONFIG

__all__ = ["CONFIG"]
