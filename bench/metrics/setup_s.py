"""Seconds from the start of the process to the start of the window:
imports, weights, building the engine or the training state, warming up
and bringing the loop to its steady state."""


def read(rec: dict):
    return rec.get("setup_s")
