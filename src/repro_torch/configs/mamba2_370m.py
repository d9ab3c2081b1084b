"""Architecture config: MAMBA2_370M (see registry.py for provenance)."""
from .registry import MAMBA2_370M as CONFIG

__all__ = ["CONFIG"]
