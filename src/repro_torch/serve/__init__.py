"""Serving layer of the port: the plan-cache service on a torch device, its
compile pool and its on-disk plan store."""
from .compile_pool import CompileJob, CompilePool
from .matpim import CacheStats, PlanService, ServeRequest, Ticket, bucket_up
from .plan_store import PlanStore, get_default_store, reset_default_store

__all__ = ["CacheStats", "CompileJob", "CompilePool", "PlanService",
           "PlanStore", "ServeRequest", "Ticket", "bucket_up",
           "get_default_store", "reset_default_store"]
