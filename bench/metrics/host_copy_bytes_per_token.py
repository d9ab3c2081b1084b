"""Bytes of logits the serving engine copied to the host per token it
sampled: the program's counter ``engine.host_copy_bytes`` over its
``engine.tokens`` (``repro_torch.obs.metrics``, always on), read from the
process-wide registry that the run shares with its driver, so over the
whole run (ramp, window, traced stretch). One float32 row of the
vocabulary padded to a multiple of 256 per token where every step's slots
are all live (201,728 B for olmo-1b's 50,432 columns); more where a step
copies empty slots' rows. Nothing to read in a program without the
counters."""


def read(rec: dict):
    if rec.get("kind") != "serve":
        return None
    from repro_torch.obs import metrics
    tokens = metrics.registry().get("engine.tokens")
    copied = metrics.registry().get("engine.host_copy_bytes")
    if tokens is None or copied is None or not tokens.value:
        return None
    return copied.value / tokens.value
