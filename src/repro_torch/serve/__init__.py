"""Serving layer of the port.

Two services live here:

* :mod:`repro_torch.serve.matpim` — the MatPIM plan-cache service
  (:class:`PlanService`) on a torch device, with its compile pool and its
  on-disk plan store.
* :mod:`repro_torch.serve.engine` — the LLM continuous-batching engine
  (:class:`Engine`) for the model stack, imported on first use of
  ``Engine`` or ``Request`` so that ``import repro_torch.serve`` stays
  light.
"""
from .compile_pool import CompileJob, CompilePool
from .matpim import (CacheStats, PlanService, ServeRequest, Ticket, bucket_up,
                     get_default_service, reset_default_service)
from .plan_store import PlanStore, get_default_store, reset_default_store

_LLM_ENGINE = ("Engine", "Request")


def __getattr__(name):
    if name in _LLM_ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(
        f"module 'repro_torch.serve' has no attribute {name!r}")


__all__ = ["CacheStats", "CompileJob", "CompilePool", "PlanService",
           "PlanStore", "ServeRequest", "Ticket", "bucket_up",
           "get_default_service", "get_default_store",
           "reset_default_service", "reset_default_store"]
