"""Model flops of the work a cell's window did, from the configuration's
sizes: the arithmetic of ``src/repro_torch/launch/analytic.py`` and the
port's layer pattern (``ModelConfig.is_attn_layer``, ``.is_moe_layer``,
``Model.kinds``), copied here so that a change to the program cannot move
the yardstick.

2·M·N·K flops a matrix product. Only useful work counts: a prefill's
attention over its causal half, one unembedding row a prefill (the row
that gives its first token), a decode step's attention over the live rows
of each slot's context, and no recomputation under remat. A Mamba-2 mixer
counts its projections, its convolution and the SSD: chunked in a prefill
or a training pass, the recurrence in a decode step; its decay and
gating are elementwise and left out, as the softmax is. An MoE counts its
router and each token's top-k experts, dropless: no capacity factor, and
no dispatch or combine, which move tokens and compute nothing.
"""
from __future__ import annotations

import collections
import math

# the port's defaults for keys a configuration file may leave out
# (``repro_torch/configs/base.py::ModelConfig``)
SSM_HEADDIM = 64
CONV_DIM = 4
SSD_CHUNK = 256          # ``models/mamba.py::ssd_chunked``'s chunk
COUNTED = ("dense", "moe", "ssm", "hybrid")


def _hd(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def _vocab_padded(cfg: dict) -> int:
    return math.ceil(cfg["vocab"] / 256) * 256


def layer_kinds(cfg: dict) -> list:
    """Each layer's ``(mixer, ffn)``, as the port lays them out: ``ssm``,
    a Mamba-2 mixer and no FFN; ``hybrid``, attention where
    ``i % attn_every == attn_every // 2`` and Mamba-2 elsewhere; ``dense``
    and ``moe``, attention. An FFN is an MoE where ``n_experts > 0`` and
    ``i % moe_every == moe_every - 1``, else an MLP."""
    family = cfg["family"]
    if family not in COUNTED:
        raise ValueError(f"flops of the {family} family are not counted "
                         f"here (only {', '.join(COUNTED)})")
    if family == "ssm":
        return [("mamba", "none")] * cfg["n_layers"]
    every = cfg.get("moe_every", 1)
    out = []
    for i in range(cfg["n_layers"]):
        mixer = "attn"
        if family == "hybrid":
            a = cfg["attn_every"]
            mixer = "attn" if i % a == a // 2 else "mamba"
        moe = cfg.get("n_experts", 0) > 0 and i % every == every - 1
        out.append((mixer, "moe" if moe else "mlp"))
    return out


def _attn(cfg: dict, T: float, ctx: float) -> float:
    """Projections of ``T`` tokens, and their scores and weighted sums
    over ``ctx`` keys each (a sum of contexts may stand for ``T·ctx``)."""
    D, H = cfg["d_model"], cfg["n_heads"]
    KV, hd = cfg["n_kv_heads"], _hd(cfg)
    return 2 * T * D * (2 * H * hd + 2 * KV * hd) + 4 * ctx * H * hd


def _mamba(cfg: dict, T: float, seq) -> float:
    """A Mamba-2 mixer over ``T`` tokens: in_proj (z, x, B, C, dt; one
    group), out_proj, the causal convolution, and the SSD, chunked over
    sequences of ``seq`` tokens, or its recurrence where ``seq`` is None
    (a decode step: the input's outer product into the state and the
    read-out)."""
    D, N = cfg["d_model"], cfg["ssm_state"]
    DI = cfg.get("d_inner") or 2 * D
    P = cfg.get("ssm_headdim", SSM_HEADDIM)
    H = DI // P
    proj = 2 * T * D * (2 * DI + 2 * N + H) + 2 * T * DI * D
    conv = 2 * T * (DI + 2 * N) * cfg.get("conv_dim", CONV_DIM)
    if seq is None:
        ssd = 4 * T * H * P * N
    else:
        L = min(SSD_CHUNK, seq)
        ssd = 2 * T * L * N + 2 * T * L * H * P + 4 * T * H * P * N
    return proj + conv + ssd


def _mlp(cfg: dict, T: float, width: int) -> float:
    mats = 3 if cfg.get("act", "swiglu") == "swiglu" else 2
    return 2 * T * cfg["d_model"] * width * mats


def _moe(cfg: dict, T: float) -> float:
    """The router, each token's ``experts_per_tok`` experts at ``d_ff``,
    and ``dense_ff``'s MLP on the same input (arctic's residual MLP,
    Granite 4.0's shared expert)."""
    E, k = cfg["n_experts"], cfg["experts_per_tok"]
    f = 2 * T * cfg["d_model"] * E + _mlp(cfg, k * T, cfg["d_ff"])
    if cfg.get("dense_ff"):
        f += _mlp(cfg, T, cfg["dense_ff"])
    return f


def _layer(cfg: dict, kind: tuple, T: float, ctx: float, seq) -> float:
    mixer, ffn = kind
    f = _attn(cfg, T, ctx) if mixer == "attn" else _mamba(cfg, T, seq)
    if ffn == "mlp":
        f += _mlp(cfg, T, cfg["d_ff"])
    elif ffn == "moe":
        f += _moe(cfg, T)
    return f


def _layers(cfg: dict, T: float, ctx: float, seq) -> float:
    """Every layer, each kind counted once and times its layers, so that
    a uniform stack counts the same float as its layer count times one
    layer."""
    count = collections.Counter(layer_kinds(cfg))
    return sum(n * _layer(cfg, kind, T, ctx, seq)
               for kind, n in count.items())


def _unembed(cfg: dict, T: float) -> float:
    return 2 * T * cfg["d_model"] * _vocab_padded(cfg)


def prefill(cfg: dict, S: int) -> float:
    """One prompt of ``S`` tokens: its layers, causal (``S²/2`` scores),
    and the unembedding of its last row."""
    return _layers(cfg, S, S * S / 2, S) + _unembed(cfg, 1)


def decode(cfg: dict, slots: int, ctx_sum: float) -> float:
    """One decode step of ``slots`` live slots whose contexts (the cached
    rows and the new one) add up to ``ctx_sum``."""
    return _layers(cfg, slots, ctx_sum, None) + _unembed(cfg, slots)


def train_step(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward (3× the forward) of ``batch`` sequences of
    ``seq`` tokens: 6·N·T and the causal attention; recomputation under
    remat is not useful work and is not counted."""
    T = batch * seq
    fwd = _layers(cfg, T, batch * seq * seq / 2, seq) + _unembed(cfg, T)
    return 3 * fwd
