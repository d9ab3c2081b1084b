"""The model flops of the traced stretch's useful work (each prompt
prefilled, each token decoded over its real context; ``bench/flops.py``)
over the seconds in which a kernel ran in that stretch (the union of the
kernels' intervals, from ``torch.profiler``), as a percentage of the
chip's dense peak in the configuration's dtype (989 TFLOP/s in bf16, H100
SXM data sheet). The device's idle time is left out: it is
``device_idle_share.serve``'s."""


def read(rec: dict):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or not tr or "trace_flops" not in rec:
        return None
    return 100.0 * rec["trace_flops"] / tr["busy_s"] / rec["peak_flops"]
