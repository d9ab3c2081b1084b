"""Architecture config: PHI4_MINI_38B (see registry.py for provenance)."""
from .registry import PHI4_MINI_38B as CONFIG

__all__ = ["CONFIG"]
