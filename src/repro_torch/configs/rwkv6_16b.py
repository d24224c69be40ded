"""Config module for RWKV6_16B (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import RWKV6_16B as CONFIG

__all__ = ["CONFIG"]
