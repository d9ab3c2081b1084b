"""Architecture config: ARCTIC_480B (see registry.py for provenance)."""
from .registry import ARCTIC_480B as CONFIG

__all__ = ["CONFIG"]
