"""Device models for the port: fault realizations (see :mod:`.faults`)."""
from .faults import IDEAL, FaultModel, FaultRealization

__all__ = ["IDEAL", "FaultModel", "FaultRealization"]
