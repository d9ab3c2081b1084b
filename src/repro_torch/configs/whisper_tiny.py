"""Architecture config: WHISPER_TINY (see registry.py for provenance)."""
from .registry import WHISPER_TINY as CONFIG

__all__ = ["CONFIG"]
