"""Serving layer of the port: the plan-cache service on a torch device."""
from .matpim import CacheStats, PlanService, ServeRequest, Ticket, bucket_up

__all__ = ["CacheStats", "PlanService", "ServeRequest", "Ticket",
           "bucket_up"]
