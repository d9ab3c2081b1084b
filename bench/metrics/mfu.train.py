"""A training step's model flops (6·N·T and the causal attention, without
recomputation; ``bench/flops.py``) over the median device time of the
window's steps, as a percentage of the chip's dense peak in the
configuration's dtype (989 TFLOP/s in bf16, H100 SXM data sheet)."""
from bench.harness import median


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("step_ms"):
        return None
    step_s = median(rec["step_ms"]) / 1e3
    return 100.0 * rec["step_flops"] / step_s / rec["peak_flops"]
