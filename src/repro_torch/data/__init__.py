"""Data (the port of ``src/repro/data``): step-indexed synthetic and
file token sources, and batches put on a device."""
from .pipeline import FileTokens, SyntheticLM, make_global_batch

__all__ = ["FileTokens", "SyntheticLM", "make_global_batch"]
