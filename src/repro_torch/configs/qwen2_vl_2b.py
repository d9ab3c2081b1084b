"""Architecture config: QWEN2_VL_2B (see registry.py for provenance)."""
from .registry import QWEN2_VL_2B as CONFIG

__all__ = ["CONFIG"]
