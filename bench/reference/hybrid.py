"""Plain float32 reference of a hybrid Mamba-2 / attention decoder without
experts (IBM Granite 4.0-H, ``granitemoehybrid``): token embedding, pre-norm
layers whose mixer is Mamba-2 or causal GQA attention without positions,
each followed by a SwiGLU MLP, a final norm and the tied unembedding; μP
multipliers on the embedding, each residual branch and the logits.

Plain ``torch`` operations on one sequence at a time, no cache and no
batching; it imports nothing of the program. Weights come in the
program's layout (a tree of dicts, each layer's leaves stacked over layer
groups of ``lcm(attn_every, moe_every)`` layers) and are widened to float32
where they are used. ``mm`` is the product of every weight (projections,
MLP, unembedding): float32's by default, a lower precision for a control.

A Mamba-2 mixer, as published (Dao and Gu, arXiv:2405.21060; Granite's
``GraniteMoeHybridMambaLayer``): ``in_proj`` gives z, x, B, C and dt; a
depthwise causal convolution with bias and SiLU over (x, B, C); ``dt =
softplus(dt + dt_bias)``, ``A = -exp(A_log)``; per head the recurrence
``h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·x_tᵀ``, ``y_t = C_t·h_t + D·x_t``;
then ``rmsnorm(y·silu(z))·w`` (the gated norm, one group) and
``out_proj``. The recurrence is computed in its dual (quadratic) form,
independently of the program's chunked scan: ``y_t = Σ_{s≤t} (C_t·B_s)
exp(Σ_{s<r≤t} dt_r·A) dt_s x_s + D·x_t``, in blocks of query rows, the
decay's exponent a difference of cumulative sums taken in float64.

Departures from the published description, all of the program's layout
and none of its mathematics: ``in_proj``'s output is laid out [z, x, B, C,
dt]; the SwiGLU's gate is the first of ``wi``'s pair; a layer is attention
where the configuration's ``layer_types`` says so, else where ``i %
attn_every == attn_every // 2`` (the program's rule, which gives the
published ``layer_types`` of granite-4.0-h-micro); the norm's epsilon is
``norm_eps``; the vocabulary is padded to a multiple of 256 and only the
first ``vocab`` logits are ever read.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
BLOCK = 512            # query rows a block of attention or of the SSD


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _check(cfg: dict):
    if (cfg["family"] != "hybrid" or cfg.get("n_experts", 0)
            or cfg.get("dense_ff", 0) or cfg.get("binary_ffn", False)
            or cfg["rope"] != "none" or cfg["norm"] != "rmsnorm"
            or cfg["act"] != "swiglu"):
        raise ValueError(f"{cfg['name']}: the hybrid reference covers "
                         f"Mamba-2 and attention without positions, "
                         f"RMSNorm, a SwiGLU MLP and no experts")


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.to(F32)


def kinds(cfg: dict) -> list:
    """Each layer's mixer, ``"attention"`` or ``"mamba"``."""
    given = cfg.get("layer_types")
    if given is not None:
        if len(given) != cfg["n_layers"]:
            raise ValueError("layer_types does not give every layer")
        return list(given)
    a = cfg["attn_every"]
    return ["attention" if i % a == a // 2 else "mamba"
            for i in range(cfg["n_layers"])]


def attention(x, cfg: dict, p: dict, mm):
    """Causal GQA without positions, the logits times
    ``attention_multiplier`` (``1/sqrt(hd)`` where it is None)."""
    S, D = x.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    q = mm(x, p["wq"].to(F32).reshape(D, H * hd)).reshape(S, H, hd)
    k = mm(x, p["wk"].to(F32).reshape(D, KV * hd)).reshape(S, KV, hd)
    v = mm(x, p["wv"].to(F32).reshape(D, KV * hd)).reshape(S, KV, hd)
    # query head h reads key/value head h // (H // KV)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    scale = cfg.get("attention_multiplier") or 1.0 / math.sqrt(hd)
    out = []
    for r0 in range(0, S, BLOCK):
        r1 = min(r0 + BLOCK, S)
        s = torch.einsum("qhd,khd->hqk", q[r0:r1], k[:r1]) * scale
        causal = (torch.arange(r0, r1, device=x.device)[:, None]
                  >= torch.arange(r1, device=x.device)[None, :])
        w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", w, v[:r1]))
    o = torch.cat(out).reshape(S, H * hd)
    return mm(o, p["wo"].to(F32).reshape(H * hd, D))


def ssd(x, dt, A, B, C):
    """The SSM's output before the skip: x (S, H, P), dt (S, H), A (H,),
    B and C (S, N) → (S, H, P), in its quadratic form, a block of query
    rows at a time."""
    S, H, P = x.shape
    cum = torch.cumsum(dt.double() * A.double(), dim=0).T     # (H, S)
    xh, dth = x.permute(1, 0, 2), dt.T                        # (H,S,P), (H,S)
    out = []
    for r0 in range(0, S, BLOCK):
        r1 = min(r0 + BLOCK, S)
        causal = (torch.arange(r0, r1, device=x.device)[:, None]
                  >= torch.arange(r1, device=x.device)[None, :])
        # the decay's exponent, a difference of float64 sums, in float32
        w = torch.exp_((cum[:, r0:r1, None] - cum[:, None, :r1]).to(F32))
        w = w.masked_fill_(~causal, 0.0)                      # (H, R, r1)
        w = w.mul_((C[r0:r1] @ B[:r1].T)[None]).mul_(dth[:, None, :r1])
        out.append(torch.bmm(w, xh[:, :r1]))                  # (H, R, P)
    return torch.cat(out, dim=1).permute(1, 0, 2)


def mamba(x, cfg: dict, p: dict, mm):
    S, _ = x.shape
    DI, N = cfg["d_inner"], cfg["ssm_state"]
    P, K = cfg["ssm_headdim"], cfg["conv_dim"]
    H = DI // P
    z, xbc, dt = torch.split(mm(x, p["in_proj"].to(F32)),
                             [DI, DI + 2 * N, H], dim=-1)
    # depthwise causal convolution: output t reads inputs t-K+1 .. t
    w = p["conv_w"].to(F32)                                   # (K, channels)
    xbc = F.conv1d(xbc.T[None], w.T[:, None, :], p["conv_b"].to(F32),
                   padding=K - 1, groups=w.shape[1])[0, :, :S].T
    xs, B, C = torch.split(F.silu(xbc), [DI, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    xs = xs.reshape(S, H, P)
    y = ssd(xs, dt, A, B, C) + p["D"].to(F32)[None, :, None] * xs
    g = y.reshape(S, DI) * F.silu(z)
    if cfg["ssm_gated_norm"]:
        g = rmsnorm(g, p["norm"], cfg["norm_eps"])
    return mm(g, p["out_proj"].to(F32))


def mlp(x, cfg: dict, p: dict, mm):
    D = x.shape[-1]
    F_ = p["wo"].shape[0]
    h = mm(x, p["wi"].to(F32).reshape(D, 2 * F_)).reshape(-1, 2, F_)
    return mm(F.silu(h[:, 0]) * h[:, 1], p["wo"].to(F32))


def layer(p: dict, g: int) -> dict:
    """Group ``g``'s leaves of a tree stacked over layer groups."""
    if isinstance(p, dict):
        return {k: layer(v, g) for k, v in p.items()}
    return p[g]


def logits(cfg: dict, params: dict, tokens: torch.Tensor, mm=matmul):
    """Float32 logits (S, padded vocabulary) of one sequence of token ids."""
    _check(cfg)
    eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
    a, m = cfg["attn_every"], cfg.get("moe_every", 1)
    period = a * m // math.gcd(a, m)
    tok = params["embed"]["tok"]
    x = tok[tokens].to(F32) * cfg["embedding_multiplier"]
    for i, kind in enumerate(kinds(cfg)):
        p = layer(params["layers"][f"sub{i % period}"], i // period)
        h = rmsnorm(x, p["norm1"]["w"], eps)
        if kind == "attention":
            y = attention(h, cfg, p["attn"], mm)
        else:
            y = mamba(h, cfg, p["mamba"], mm)
        x = x + r * y
        x = x + r * mlp(rmsnorm(x, p["norm2"]["w"], eps), cfg, p["mlp"], mm)
    x = rmsnorm(x, params["final_norm"]["w"], eps)
    w = params["embed"].get("unembed")
    w = tok.T if w is None else w
    return mm(x, w.to(F32)) / cfg["logits_scaling"]
