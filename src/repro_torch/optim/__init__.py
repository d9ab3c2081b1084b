"""Optimizers (the port of ``src/repro/optim``): AdamW with float32 or
int8 moments, and 1-bit gradient compression with error feedback."""
from . import grad_compress
from .optimizer import AdamW, QTensor, make_optimizer

__all__ = ["AdamW", "QTensor", "grad_compress", "make_optimizer"]
