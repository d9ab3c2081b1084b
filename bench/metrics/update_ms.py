"""Median device time in milliseconds of the window's optimizer updates,
from the mark after the gradients to the step's end (CUDA events)."""
from bench.harness import median


def read(rec: dict):
    return median(rec.get("update_ms", []))
