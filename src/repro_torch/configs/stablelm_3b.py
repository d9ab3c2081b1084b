"""Architecture config: STABLELM_3B (see registry.py for provenance)."""
from .registry import STABLELM_3B as CONFIG

__all__ = ["CONFIG"]
