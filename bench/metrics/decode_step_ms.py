"""Median device time in milliseconds of the window's decode steps
(``Engine.timings()["decode_ms"]``, CUDA events around
``Model.decode_step``)."""
from bench.harness import median


def read(rec: dict):
    return median(rec.get("decode_ms", []))
