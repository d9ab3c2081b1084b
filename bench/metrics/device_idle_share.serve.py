"""The share, in percent, of a traced stretch of serving (after the window)
in which no kernel ran on the device: 1 - the union of the kernels'
intervals over the stretch, from ``torch.profiler``."""


def read(rec: dict):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
