"""Config module for GPT_350M (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import GPT_350M as CONFIG

__all__ = ["CONFIG"]
