"""Bytes of Mamba-2 state that the program's decode steps copied back
into the serving engine's buffers per token it sampled: the program's
counter ``mamba.decode.state_copy_bytes`` over its ``engine.tokens``
(``repro_torch.obs.metrics``, always on), read from the process-wide
registry that the run shares with its driver, so over the whole run
(ramp, window, traced stretch). The conv and SSM states of every Mamba-2
layer, once per decoded token where both are copied back: (2,097,152 +
26,112) B x 36 = 76.4 MB for granite-4.0-h-micro, a little less per
sampled token, since a request's first token comes from its prefill.
Nothing to read in a program without the counter, or in a run with no
Mamba-2 layer."""


def read(rec: dict):
    if rec.get("kind") != "serve":
        return None
    from repro_torch.obs import metrics
    tokens = metrics.registry().get("engine.tokens")
    copied = metrics.registry().get("mamba.decode.state_copy_bytes")
    if tokens is None or copied is None or not tokens.value:
        return None
    return copied.value / tokens.value
