"""Analytic FLOPs / HBM-bytes model per (arch × shape) cell, the port of
``src/repro/launch/analytic.py`` with the same values.

A closed-form count of every matmul in the model; the einsum structure
mirrors models/layers.py one-to-one. The module holds no device constant:
a caller divides by its own device's rates (:func:`roofline_ms`).
Conventions:

* 2·M·N·K FLOPs per matmul; backward = 2× forward; full remat adds one
  extra forward over the layer stack (not embeddings).
* HBM bytes: every parameter read once per forward pass over it (+grad
  write + optimizer read/write for training); activations r/w per layer
  boundary; decode adds the full KV-cache / SSM-state read per token.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig


def _attn_flops(cfg: ModelConfig, T: float, S_ctx: float) -> float:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    proj = 2 * T * D * (H * hd + 2 * KV * hd + H * hd)
    scores = 2 * T * S_ctx * H * hd * 2            # QK^T and PV
    return proj + scores


def _mlp_flops(cfg: ModelConfig, T: float, d_ff: int) -> float:
    n_mats = 3 if cfg.act == "swiglu" else 2
    return 2 * T * cfg.d_model * d_ff * n_mats


def _moe_flops(cfg: ModelConfig, T: float) -> float:
    E, k, D = cfg.n_experts, cfg.experts_per_tok, cfg.d_model
    n_mats = 3 if cfg.act == "swiglu" else 2
    expert = 2 * (T * k * cfg.capacity_factor) * D * cfg.d_ff * n_mats
    C = max(k * cfg.capacity_factor / E, 1e-9)     # per-token capacity share
    dispatch = 2 * 2 * T * E * (T * C / max(T, 1)) * D  # dispatch+combine
    router = 2 * T * D * E
    return expert + dispatch + router


def _mamba_flops(cfg: ModelConfig, T: float, chunk: int = 256) -> float:
    D, DI, N, H, P = cfg.d_model, cfg.di, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    proj = 2 * T * D * (2 * DI + 2 * N + H) + 2 * T * DI * D
    conv = 2 * T * (DI + 2 * N) * cfg.conv_dim
    L = min(chunk, int(T) if T else chunk)
    # intra-chunk: scores T·L·N + att·x T·L·H·P ; states/inter: T·H·P·N ×2
    ssd = 2 * T * L * N + 2 * T * L * H * P + 4 * T * H * P * N
    return proj + conv + ssd


def layer_flops(cfg: ModelConfig, i: int, T: float, S_ctx: float) -> float:
    f = 0.0
    mixer_attn = cfg.is_attn_layer(i)
    if mixer_attn:
        f += _attn_flops(cfg, T, S_ctx)
    else:
        f += _mamba_flops(cfg, T)
    if cfg.family == "ssm":
        return f
    if cfg.is_moe_layer(i):
        f += _moe_flops(cfg, T)
        if cfg.dense_ff:
            f += _mlp_flops(cfg, T, cfg.dense_ff)
    else:
        f += _mlp_flops(cfg, T, cfg.d_ff)
    return f


def forward_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        T, S_ctx = float(B), float(S)
    else:
        T, S_ctx = float(B) * S, float(S) / 2  # causal: avg context S/2
    layers = sum(layer_flops(cfg, i, T, S_ctx) for i in range(cfg.n_layers))
    embed = 2 * T * cfg.d_model * cfg.vocab_padded  # unembed matmul
    enc = 0.0
    if cfg.family == "encdec":
        Te = float(B) * cfg.enc_seq
        enc = cfg.enc_layers * (_attn_flops(cfg, Te, cfg.enc_seq)
                                + _mlp_flops(cfg, Te, cfg.d_ff))
        # cross attention (scores vs enc_seq) per decoder layer
        enc += cfg.n_layers * (2 * T * cfg.d_model * 2 * cfg.n_kv_heads * cfg.hd
                               + 2 * T * cfg.enc_seq * cfg.n_heads * cfg.hd * 2)
    return {"layers": layers, "embed": embed, "encoder": enc}


def cell_flops(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig) -> float:
    f = forward_flops(cfg, shape)
    fwd = f["layers"] + f["encoder"]
    if shape.kind == "train":
        mult = 3.0 + (1.0 if tc.remat != "none" else 0.0)
        return mult * fwd + 3.0 * f["embed"]
    return fwd + f["embed"]


def param_bytes(cfg: ModelConfig, n_params: float) -> float:
    return n_params * (2 if cfg.dtype == "bfloat16" else 4)


def cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    dt = 2 if cfg.dtype == "bfloat16" else 4
    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            total += 2 * B * S * cfg.n_kv_heads * cfg.hd * dt
        else:
            total += B * (cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
                          + (cfg.conv_dim - 1) * (cfg.di + 2 * cfg.ssm_state) * dt)
    if cfg.family == "encdec":
        total += 2 * cfg.n_layers * B * cfg.enc_seq * cfg.n_kv_heads * cfg.hd * dt
    return total


def act_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Rough per-layer activation traffic: ~12 tensor r/w of (T, D)."""
    B, S = shape.global_batch, shape.seq_len
    T = B * (1 if shape.kind == "decode" else S)
    dt = 2 if cfg.dtype == "bfloat16" else 4
    per_layer = 12 * T * cfg.d_model * dt
    logits = T * cfg.vocab_padded * 4
    return cfg.n_layers * per_layer + logits


def cell_bytes(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig,
               n_params: float) -> float:
    pb = param_bytes(cfg, n_params)
    ab = act_bytes(cfg, shape)
    if shape.kind == "train":
        # params: fwd read + bwd read + remat read + grad write + opt r/w
        opt = 2.0 if tc.opt_state_dtype == "int8" else 8.0
        return pb * (3 + 1 + opt) + ab * (2 + (1 if tc.remat != "none" else 0))
    if shape.kind == "decode":
        return pb + cache_bytes(cfg, shape) + ab
    return pb + ab  # prefill


def roofline_ms(flops: float, nbytes: float, flops_per_s: float,
                bytes_per_s: float) -> dict:
    """The least time in ms for ``flops`` and ``nbytes`` on a device with
    the given peak rates: the larger of the two times, and which bounds."""
    t_flops = flops / flops_per_s * 1e3
    t_bytes = nbytes / bytes_per_s * 1e3
    return {"flops_ms": t_flops, "bytes_ms": t_bytes,
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes"}


__all__ = ["act_bytes", "cache_bytes", "cell_bytes", "cell_flops",
           "forward_flops", "layer_flops", "param_bytes", "roofline_ms"]
