"""Architecture config: IBM Granite 4.0-H Micro (``granitemoehybrid``, 3B),
a configuration of the port's own: the reference's registry has no such
model, so it lives here and not in ``registry.py`` (whose ``REGISTRY``
stays the reference's); ``get_config`` finds it and its ``-smoke``.

Source: https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json

40 layers with a period of 10: attention at layers 5, 15, 25 and 35 (the
published ``layer_types``; ``attn_every`` 10), Mamba-2 elsewhere (64 heads
of 64, ``d_inner`` 4096, state 128, one group, conv 4 with bias, chunk
256, a gated RMSNorm before ``out_proj``). Attention is GQA, 32 query heads
on 8 KV heads of 64 (``hidden_size / num_attention_heads``), no positions
(``position_embedding_type`` "nope"), its logits scaled by
``attention_multiplier``. A SwiGLU MLP of 8192 on every layer
(``shared_intermediate_size``; no experts). RMSNorm ε 1e-5, μP multipliers
on the embedding (×12), each residual branch (×0.22) and the logits (÷8),
a tied vocabulary of 100,352 rows.
"""
from .base import ModelConfig

GRANITE_4_0_H_MICRO = ModelConfig(
    name="granite-4.0-h-micro", family="hybrid",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=100352,
    ssm_state=128, d_inner=4096, ssm_headdim=64, conv_dim=4, attn_every=10,
    rope="none", rope_theta=10000.0,
    norm_eps=1e-5, embedding_multiplier=12.0, attention_multiplier=0.015625,
    residual_multiplier=0.22, logits_scaling=8.0, ssm_gated_norm=True,
)

CONFIG = GRANITE_4_0_H_MICRO

__all__ = ["CONFIG", "GRANITE_4_0_H_MICRO"]
