"""Architecture config: OLMO_1B (see registry.py for provenance)."""
from .registry import OLMO_1B as CONFIG

__all__ = ["CONFIG"]
