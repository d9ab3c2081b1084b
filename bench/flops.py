"""Model flops of the work a cell's window did, from the configuration's
sizes: the arithmetic of ``src/repro_torch/launch/analytic.py``, copied
here so that a change to the program cannot move the yardstick.

2·M·N·K flops a matrix product. Only useful work counts: a prefill's
attention over its causal half, one unembedding row a prefill (the row
that gives its first token), a decode step's attention over the live rows
of each slot's context, and no recomputation under remat.
"""
from __future__ import annotations

import math


def _hd(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def _vocab_padded(cfg: dict) -> int:
    return math.ceil(cfg["vocab"] / 256) * 256


def _attn(cfg: dict, T: float, ctx: float) -> float:
    """Projections of ``T`` tokens, and their scores and weighted sums
    over ``ctx`` keys each (a sum of contexts may stand for ``T·ctx``)."""
    D, H = cfg["d_model"], cfg["n_heads"]
    KV, hd = cfg["n_kv_heads"], _hd(cfg)
    return 2 * T * D * (2 * H * hd + 2 * KV * hd) + 4 * ctx * H * hd


def _mlp(cfg: dict, T: float) -> float:
    mats = 3 if cfg.get("act", "swiglu") == "swiglu" else 2
    return 2 * T * cfg["d_model"] * cfg["d_ff"] * mats


def _layers(cfg: dict, T: float, ctx: float) -> float:
    if cfg["family"] != "dense" or cfg.get("n_experts", 0):
        raise ValueError(f"flops of {cfg['family']} layers or experts are "
                         "not counted here yet")
    return cfg["n_layers"] * (_attn(cfg, T, ctx) + _mlp(cfg, T))


def _unembed(cfg: dict, T: float) -> float:
    return 2 * T * cfg["d_model"] * _vocab_padded(cfg)


def prefill(cfg: dict, S: int) -> float:
    """One prompt of ``S`` tokens: its layers, causal (``S²/2`` scores),
    and the unembedding of its last row."""
    return _layers(cfg, S, S * S / 2) + _unembed(cfg, 1)


def decode(cfg: dict, slots: int, ctx_sum: float) -> float:
    """One decode step of ``slots`` live slots whose contexts (the cached
    rows and the new one) add up to ``ctx_sum``."""
    return _layers(cfg, slots, ctx_sum) + _unembed(cfg, slots)


def train_step(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward (3× the forward) of ``batch`` sequences of
    ``seq`` tokens: 6·N·T and the causal attention; recomputation under
    remat is not useful work and is not counted."""
    T = batch * seq
    fwd = _layers(cfg, T, batch * seq * seq / 2) + _unembed(cfg, T)
    return 3 * fwd
