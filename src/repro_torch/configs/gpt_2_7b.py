"""Config module for GPT_2_7B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import GPT_2_7B as CONFIG

__all__ = ["CONFIG"]
