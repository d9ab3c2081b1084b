"""Config system: one dataclass covers every assigned architecture family."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_every: int = 1              # a layer is MoE iff (layer % moe_every == moe_every-1)
    dense_ff: int = 0               # extra dense residual MLP (arctic)
    capacity_factor: float = 1.25

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    d_inner: int = 0                # default 2*d_model when family uses ssm
    ssm_headdim: int = 64
    conv_dim: int = 4
    attn_every: int = 0             # hybrid: 1 attention layer per this many

    # --- norms / activations / position ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparametric
    act: str = "swiglu"             # swiglu | gelu
    rope: str = "standard"          # standard | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # qwen2-vl t/h/w

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500             # audio frames after the (stubbed) conv frontend

    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # --- MatPIM feature: binary (XNOR-popcount) FFN variant ---
    binary_ffn: bool = False

    # --- the port's own fields (the reference's ModelConfig has none of
    # them); each default is the arithmetic of a config without it, and
    # the model branches on the value, so a default adds no operation ---
    norm_eps: float = 1e-6
    embedding_multiplier: float = 1.0     # μP: the token embedding's scale
    attention_multiplier: Optional[float] = None   # logit scale; 1/sqrt(hd)
    residual_multiplier: float = 1.0      # μP: each branch before its add
    logits_scaling: float = 1.0           # μP: the logits are divided by it
    ssm_gated_norm: bool = False          # Mamba-2's RMSNorm(y·silu(z))·w

    # ----------------------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def di(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.di // self.ssm_headdim

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so it shards over the mesh."""
        return math.ceil(self.vocab / 256) * 256

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid models: which layers are attention (rest are mamba)."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return (i % self.attn_every) == (self.attn_every // 2)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (CPU-runnable)."""
        small = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            experts_per_tok=min(self.experts_per_tok, 2),
            dense_ff=64 if self.dense_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            d_inner=128 if (self.family in ("ssm", "hybrid")) else 0,
            ssm_headdim=32,
            attn_every=self.attn_every if self.attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=32 if self.enc_layers else 1500,
            name=self.name + "-smoke",
        )
        if self.family == "hybrid":
            small["n_layers"] = max(self.attn_every, 4)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic sequence mixing: only SSM/hybrid run it
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg: ModelConfig):
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
            continue  # full-attention archs skip (see docs/ARCHITECTURE.md §Model stack)
        out.append(s)
    return out


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-side knobs (remat, microbatching, optimizer precision)."""
    microbatches: int = 1           # gradient-accumulation steps per batch
    remat: str = "full"             # none | full | dots
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    opt_state_dtype: str = "float32"   # float32 | int8 (quantized moments)
    grad_compress: str = "none"        # none | onebit (cross-pod all-reduce)
