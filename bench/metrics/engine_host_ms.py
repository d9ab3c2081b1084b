"""Median over the window's decode steps of the host's wall time of
``Engine.step`` (the benchmark's own clock around the call) less that
step's device time (``Engine.timings()``'s CUDA events): the engine's
host work that the device does not hide, the logits' copy to the host
and the sampling among it."""
from bench.harness import median


def read(rec: dict):
    host, dev = rec.get("step_host_ms"), rec.get("decode_ms")
    if not host or not dev or len(host) != len(dev):
        return None
    return median(h - d for h, d in zip(host, dev))
