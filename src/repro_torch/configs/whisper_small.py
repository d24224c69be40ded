"""Config module for WHISPER_SMALL (see archs.py for the literal pool values)."""
from repro_torch.configs.archs import WHISPER_SMALL as CONFIG

__all__ = ["CONFIG"]
