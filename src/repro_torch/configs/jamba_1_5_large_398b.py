"""Architecture config: JAMBA_15_LARGE (see registry.py for provenance)."""
from .registry import JAMBA_15_LARGE as CONFIG

__all__ = ["CONFIG"]
