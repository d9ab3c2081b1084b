"""The model zoo on torch (param specs + apply fns), the port of
``src/repro/models``; see lm.py for assembly."""
from . import layers, mamba, spec
from .lm import Model, build_model

__all__ = ["Model", "build_model", "layers", "mamba", "spec"]
