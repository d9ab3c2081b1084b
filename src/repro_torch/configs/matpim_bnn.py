"""Architecture config: MATPIM_BNN (see registry.py for provenance)."""
from .registry import MATPIM_BNN as CONFIG

__all__ = ["CONFIG"]
