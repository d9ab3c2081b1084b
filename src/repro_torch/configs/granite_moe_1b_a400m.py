"""Architecture config: GRANITE_MOE_1B (see registry.py for provenance)."""
from .registry import GRANITE_MOE_1B as CONFIG

__all__ = ["CONFIG"]
