"""Plain float32 reference of a dense decoder-only transformer (OLMo):
token embedding, pre-norm blocks of causal multi-head attention with rotary
positions and a SwiGLU (or GeLU) MLP, a final norm, and the unembedding.

Plain ``torch`` operations on one sequence at a time, no cache and no
batching; it imports nothing of the program. Weights come as the
benchmark made them, in the program's layout (a tree of dicts, each
layer's leaves stacked on a first axis), and are widened to float32 a
layer at a time. ``mm`` is the matrix product of every weight: the plain
float32 one by default, a lower-precision one for a control.

Departures from the published description, all of the program's layout
and none of its mathematics: rotary pairs are the even and odd entries of
a head (OLMo rotates the two halves, the same up to a fixed permutation of
the query and key columns); the norm's epsilon is the configuration's
``norm_eps``; the vocabulary is padded to a multiple of 256 and only the
first ``vocab`` logits are ever read.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _check(cfg: dict):
    if cfg["family"] != "dense" or cfg.get("n_experts", 0) \
            or cfg.get("rope", "standard") != "standard":
        raise ValueError(f"{cfg['name']}: the dense reference covers "
                         f"dense stacks with standard rotary positions")


def norm(x, cfg: dict, p: dict):
    eps = cfg["norm_eps"]
    if cfg["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * p["w"].to(F32)
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if cfg["norm"] == "layernorm":
        y = y * p["w"].to(F32) + p["b"].to(F32)
    return y


def rope(x, theta: float):
    """x (S, H, hd): entries ``2i`` and ``2i+1`` of each head turned by
    ``pos · theta^(-2i/hd)``."""
    S, _, hd = x.shape
    inv = 1.0 / torch.pow(theta, torch.arange(0, hd, 2, dtype=F32,
                                              device=x.device) / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(x, cfg: dict, p: dict, mm):
    S, D = x.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    q = mm(x, p["wq"].to(F32).reshape(D, H * hd)).reshape(S, H, hd)
    k = mm(x, p["wk"].to(F32).reshape(D, KV * hd)).reshape(S, KV, hd)
    v = mm(x, p["wv"].to(F32).reshape(D, KV * hd)).reshape(S, KV, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    # query head h reads key/value head h // (H // KV)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", w, v).reshape(S, H * hd)
    return mm(o, p["wo"].to(F32).reshape(H * hd, D))


def mlp(x, cfg: dict, p: dict, mm):
    D = x.shape[-1]
    if cfg.get("act", "swiglu") == "swiglu":
        F_ = p["wo"].shape[0]
        h = mm(x, p["wi"].to(F32).reshape(D, 2 * F_)).reshape(-1, 2, F_)
        h = F.silu(h[:, 0]) * h[:, 1]
    else:
        h = F.gelu(mm(x, p["wi"].to(F32)), approximate="tanh")
    return mm(h, p["wo"].to(F32))


def layer(p: dict, i: int) -> dict:
    """Layer ``i``'s leaves of a tree stacked over layers."""
    if isinstance(p, dict):
        return {k: layer(v, i) for k, v in p.items()}
    return p[i]


def logits(cfg: dict, params: dict, tokens: torch.Tensor, mm=matmul):
    """Float32 logits (S, padded vocabulary) of one sequence of token ids."""
    _check(cfg)
    tok = params["embed"]["tok"]
    x = tok[tokens].to(F32)
    stack = params["layers"]["sub0"]
    for i in range(cfg["n_layers"]):
        p = layer(stack, i)
        x = x + attention(norm(x, cfg, p.get("norm1", {})), cfg, p["attn"], mm)
        x = x + mlp(norm(x, cfg, p.get("norm2", {})), cfg, p["mlp"], mm)
    x = norm(x, cfg, params.get("final_norm", {}))
    w = params["embed"].get("unembed")
    w = tok.T if w is None else w
    return mm(x, w.to(F32))
