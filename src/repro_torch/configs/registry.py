"""Architecture registry: the 10 assigned configs (+ the paper's own BNN demo).

Sources are noted per config; numbers follow the assignment sheet verbatim.
"""
from __future__ import annotations

from .base import ModelConfig
from .granite_4_0_h_micro import GRANITE_4_0_H_MICRO

# [arXiv:2212.04356] enc-dec, conv frontend stubbed (precomputed frames)
WHISPER_TINY = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    enc_layers=4, enc_seq=1500, norm="layernorm", act="gelu", rope="none",
)

# [arXiv:2405.21060] attention-free SSD
MAMBA2_370M = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, d_inner=2048, ssm_headdim=64, rope="none",
)

# [hf:ibm-granite/granite-3.0-1b-a400m-base] 32 experts top-8
GRANITE_MOE_1B = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
    n_experts=32, experts_per_tok=8,
)

# [hf:Snowflake/snowflake-arctic-base] 128 experts top-2 + dense residual
ARCTIC_480B = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
    n_experts=128, experts_per_tok=2, dense_ff=4864,
)

# [hf:stabilityai/stablelm-2] dense, full MHA
STABLELM_3B = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
)

# [arXiv:2403.04652] llama-arch GQA
YI_34B = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
)

# [arXiv:2402.00838] non-parametric LN
OLMO_1B = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304,
    norm="nonparametric",
)

# [arXiv:2412.08905] RoPE SwiGLU GQA, huge vocab
PHI4_MINI_38B = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064,
)

# [arXiv:2409.12191] M-RoPE, patch frontend stubbed
QWEN2_VL_2B = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936,
    rope="mrope",
)

# [arXiv:2403.19887] Mamba+attn 1:7 interleave, MoE 16e top-2 every 2 layers
JAMBA_15_LARGE = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    n_experts=16, experts_per_tok=2, moe_every=2,
    ssm_state=16, d_inner=16384, ssm_headdim=64, attn_every=8,
)

# The paper's own domain: a binary (XNOR) MLP classifier — MatPIM §II-B as a
# first-class model family (binary_ffn=True routes FFNs through the
# XNOR-popcount kernel).
MATPIM_BNN = ModelConfig(
    name="matpim-bnn", family="dense",
    n_layers=4, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=32768,
    binary_ffn=True,
)

REGISTRY = {c.name: c for c in [
    WHISPER_TINY, MAMBA2_370M, GRANITE_MOE_1B, ARCTIC_480B, STABLELM_3B,
    YI_34B, OLMO_1B, PHI4_MINI_38B, QWEN2_VL_2B, JAMBA_15_LARGE, MATPIM_BNN,
]}

ASSIGNED = [c.name for c in [
    WHISPER_TINY, MAMBA2_370M, GRANITE_MOE_1B, ARCTIC_480B, STABLELM_3B,
    YI_34B, OLMO_1B, PHI4_MINI_38B, QWEN2_VL_2B, JAMBA_15_LARGE,
]]


# configurations of the port's own, which the reference's registry lacks
# (kept out of ``REGISTRY``, which equals the reference's)
PORT_ONLY = {c.name: c for c in [GRANITE_4_0_H_MICRO]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[:-6]).reduced()
    return REGISTRY[name] if name in REGISTRY else PORT_ONLY[name]
