"""Median device time in milliseconds of the window's prefills
(``Engine.timings()["prefill_ms"]``, CUDA events around the forward and
the cache handoff)."""
from bench.harness import median


def read(rec: dict):
    return median(rec.get("prefill_ms", []))
