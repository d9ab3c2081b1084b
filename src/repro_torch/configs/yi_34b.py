"""Architecture config: YI_34B (see registry.py for provenance)."""
from .registry import YI_34B as CONFIG

__all__ = ["CONFIG"]
