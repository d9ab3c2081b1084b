"""Median device time in milliseconds of the window's training steps from
their start to the mark before the optimizer's update: the loss, its
gradients with remat, and their norm (CUDA events)."""
from bench.harness import median


def read(rec: dict):
    return median(rec.get("grad_ms", []))
