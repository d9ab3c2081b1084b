"""Model building blocks: norms, RoPE/M-RoPE, GQA attention (+KV cache),
MLP (SwiGLU/GeLU), MoE (GShard capacity dispatch), binary (±1) FFN.

The port of ``src/repro/models/layers.py``. All functions are pure:
``apply(params, cfg, x, ...) -> y`` on torch tensors, with the reference's
arithmetic: float32 norms, rotary angles, attention logits and softmax,
``-1e30`` masking, the tanh GeLU, and MoE dispatch and combine tensors in
bfloat16. A float64 model computes in float64 where the reference takes
float32 (:func:`.spec.wide`), as a precision reference. Parameter *specs*
(shape + logical sharding axes) are built by the ``*_specs`` functions; see
:mod:`.spec`. Activation constraints use logical names resolved in
:mod:`repro_torch.distributed.sharding`. On a process-group mesh the
attention softmax over a split axis (a decode cache split on
'cache_seq') reduces each rank's partial maximum and sum and never
gathers the logits (:func:`repro_torch.distributed.spmd.softmax`); the
MoE router's softmax gathers its experts axis, which ``topk`` needs
whole. A decode step writes its new row into the cache in place, and
reads a plain cache through the hand-written ``decode_attention`` kernel
(:func:`attention_decode`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from ..distributed.sharding import (as_dtensor, constrain, redistribute,
                                    shard_offset)
from ..distributed.spmd import einsum, reshape, softmax
from ..kernels import decode_attention as _decode
from ..obs import metrics as _metrics
from .spec import Spec, wide


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig):
    if cfg.norm == "rmsnorm":
        return {"w": Spec((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        return {"w": Spec((cfg.d_model,), ("embed",), "ones"),
                "b": Spec((cfg.d_model,), ("embed",), "zeros")}
    return {}  # non-parametric (olmo)


def apply_norm(p, cfg: ModelConfig, x):
    acc = wide(x.dtype)
    xf = x.to(acc)
    if cfg.norm == "rmsnorm":
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        return (y * p["w"].to(acc)).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    if cfg.norm == "layernorm":
        y = y * p["w"].to(acc) + p["b"].to(acc)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------


def _rope_angles(pos, hd: int, theta: float, dtype=torch.float32):
    """pos (..., S) -> cos/sin (..., S, hd/2), in ``dtype``."""
    exps = torch.arange(0, hd, 2, dtype=dtype, device=pos.device) / hd
    freqs = 1.0 / torch.pow(theta, exps)
    ang = pos[..., None].to(dtype) * freqs
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=None)
def _mrope_index(hd: int, sections: tuple, device: torch.device):
    """The (t, h, w) section of each of the hd/2 rotary frequencies, on
    ``device`` (built once: a host-to-device copy waits for the card)."""
    secs = torch.cumsum(torch.tensor((0,) + sections), 0)
    idx = torch.clamp(torch.searchsorted(
        secs[1:], torch.arange(hd // 2), right=True), 0, 2)
    return idx.to(device), torch.arange(hd // 2, device=device)


def apply_rope(x, pos, theta: float, mrope_sections=None):
    """x (B, S, H, hd); pos (B, S) or (3, B, S) for M-RoPE."""
    acc = wide(x.dtype)
    hd = x.shape[-1]
    if mrope_sections is None:
        cos, sin = _rope_angles(pos, hd, theta, acc)     # (B, S, hd/2)
    else:
        # M-RoPE: the hd/2 frequencies are partitioned into (t, h, w)
        # sections, each rotated by its own position stream.
        cos3, sin3 = _rope_angles(pos, hd, theta, acc)   # (3, B, S, hd/2)
        idx, f = _mrope_index(hd, tuple(mrope_sections), x.device)
        cos = cos3.movedim(0, -1)[..., f, idx]
        sin = sin3.movedim(0, -1)[..., f, idx]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf1, xf2 = x[..., ::2].to(acc), x[..., 1::2].to(acc)
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return reshape(torch.stack([o1, o2], dim=-1), x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional cross-attention, optional KV cache)
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, cross: bool = False):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": Spec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((H, hd, D), ("heads", "head_dim", "embed")),
    }


def _qkv(p, cfg: ModelConfig, xq, xkv):
    q = einsum("bsd,dhk->bshk", xq, p["wq"])
    k = einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = einsum("bsd,dhk->bshk", xkv, p["wv"])
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    return q, k, v


def logit_divisor(cfg: Optional[ModelConfig], hd: int) -> float:
    """What attention's logits over heads of ``hd`` are divided by:
    ``sqrt(hd)``, or ``1 / attention_multiplier`` where the config sets one
    (μP's ``1/hd``: a power of two there, so dividing equals multiplying
    by the multiplier exactly). The decode kernel divides by the same
    float."""
    m = getattr(cfg, "attention_multiplier", None)
    return math.sqrt(hd) if m is None else 1.0 / m


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q (B,Sq,H,hd); k/v (B,Skv,KV,hd); mask (B|1, Sq, Skv) or None.

    The reference's arithmetic, written out: float32 logits divided by
    ``sqrt(hd)`` (:func:`logit_divisor`), masked to ``-1e30``, a float32
    softmax and a float32 weighted sum, cast back to q's dtype (float64
    throughout for a float64 model, :func:`~repro_torch.models.spec.wide`).

    On a decode cache split over its sequence ('cache_seq'), the logits
    stay split: the softmax reduces each rank's maximum and sum
    (:func:`~repro_torch.distributed.spmd.softmax`), and the weighted sum
    is a ``Partial`` sum over the ranks, reduced once (the reference's
    partial sums and tree reduction).
    """
    acc = wide(q.dtype)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = reshape(q, B, Sq, KV, rep, hd)
    logits = einsum("bqkrh,bskh->bkrqs", qg.to(acc), k.to(acc))
    logits = logits / logit_divisor(cfg, hd)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :, :], -1e30)
    w = softmax(logits, dim=-1)
    out = einsum("bkrqs,bskh->bqkrh", w, v.to(acc))
    return reshape(out, B, Sq, H, hd).to(q.dtype)


def attention(p, cfg: ModelConfig, x, pos, *, causal: bool,
              positions3=None, kv_override=None):
    """Full (train/prefill) attention. Returns y and (k, v) for caching."""
    q, k, v = _qkv(p, cfg, x, x if kv_override is None else kv_override)
    if cfg.rope != "none":
        sections = cfg.mrope_sections if cfg.rope == "mrope" else None
        rp = positions3 if sections is not None else pos
        q = apply_rope(q, rp, cfg.rope_theta, sections)
        k = apply_rope(k, rp, cfg.rope_theta, sections)
    mask = None
    if causal:
        S = x.shape[1]
        ar = torch.arange(S, device=x.device)
        mask = (ar[:, None] >= ar[None, :])[None]             # (1,S,S)
    o = _sdpa(q, k, v, mask, cfg)
    y = einsum("bshk,hkd->bsd", o, p["wo"])
    return constrain(y, ("batch", None, None)), (k, v)


def cross_attention(p, cfg: ModelConfig, x, enc_kv):
    """Decoder cross-attention against precomputed encoder K/V."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = enc_kv
    o = _sdpa(q, k, v, None, cfg)
    return einsum("bshk,hkd->bsd", o, p["wo"])


@functools.lru_cache(maxsize=None)
def _slots(n: int, device: torch.device):
    """``arange(n)`` on ``device``, the batch index of a row write (built
    once: a launch a call otherwise)."""
    return torch.arange(n, device=device)


def _write_rows(cache, pos, row) -> None:
    """Set ``row[b]`` at sequence index ``pos[b]`` of every batch slot ``b``
    of ``cache`` (B, S_max, KV, hd), in place: the port updates the cache
    where the reference's jitted step takes it donated and returns a new
    one.

    On a DTensor cache whose sequence axis is split ('cache_seq' over
    'model'), DTensor's ``index_put_`` would all-gather the whole cache to
    write one row. Here each rank writes the rows that fall in its own
    block of the sequence into its local shard and keeps the others (as
    :func:`~repro_torch.distributed.sharding.write_block` does for a
    prefill): the cache is never gathered, and only the new row (and
    ``pos``) is brought to the cache's placement over the batch and the KV
    heads."""
    if not isinstance(cache, DTensor):
        cache.index_put_((_slots(cache.shape[0], pos.device), pos), row)
        return
    seq = [isinstance(q, Shard) and q.dim == 1 for q in cache.placements]
    # the row lacks the sequence axis: dims past it move down by one
    row_pl = tuple(Replicate() if s or not isinstance(q, Shard)
                   else Shard(q.dim - (q.dim > 1))
                   for s, q in zip(seq, cache.placements))
    pos_pl = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate()
                   for q in cache.placements)
    mesh = cache.device_mesh
    c = cache.to_local()
    r = redistribute(as_dtensor(row, mesh), row_pl).to_local()
    at = redistribute(as_dtensor(pos, mesh), pos_pl).to_local() \
        - shard_offset(cache, 1)
    n = c.shape[1]
    inside = (at >= 0) & (at < n)
    b = _slots(c.shape[0], c.device)
    at = at.clamp(0, n - 1)
    c.index_put_((b, at), torch.where(inside[:, None, None], r, c[b, at]))


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos):
    """One-token decode against a (B, S_max, KV, hd) cache; returns y.

    ``pos`` (B,) is the write index. The new k/v row is *set* at ``pos``
    (not added), in place (:func:`_write_rows`), so a recycled batch slot
    with stale rows stays correct; rows past ``pos`` are masked out of the
    softmax.

    A plain float32 or bfloat16 cache is read by
    :func:`~repro_torch.kernels.decode_attention.decode_attention`, which
    reads each slot's rows up to ``pos`` once and no others. A DTensor
    cache (its sequence split over ranks) and one of another dtype (the
    float64 precision reference) keep :func:`_sdpa`'s masked softmax over
    the whole cache. The two paths count their calls in
    ``attention.decode.kernel`` and ``attention.decode.plain``
    (:mod:`repro_torch.obs.metrics`, always on).
    """
    B, Smax = cache_k.shape[0], cache_k.shape[1]
    q, k, v = _qkv(p, cfg, x, x)
    if cfg.rope != "none":
        sections = cfg.mrope_sections if cfg.rope == "mrope" else None
        if sections is not None:
            rp = pos[None, :, None].expand(3, B, 1)
        else:
            rp = pos[:, None]
        q = apply_rope(q, rp, cfg.rope_theta, sections)
        k = apply_rope(k, rp, cfg.rope_theta, sections)
    _write_rows(cache_k, pos, k[:, 0].to(cache_k.dtype))
    _write_rows(cache_v, pos, v[:, 0].to(cache_v.dtype))
    cache_k = constrain(cache_k, ("batch", "cache_seq", "kv_heads", None))
    cache_v = constrain(cache_v, ("batch", "cache_seq", "kv_heads", None))
    if not isinstance(cache_k, DTensor) and cache_k.dtype in _decode.DTYPES:
        _metrics.counter("attention.decode.kernel").inc()
        o = _decode.decode_attention(q, cache_k, cache_v, pos,
                                     logit_divisor(cfg, q.shape[-1]))
    else:
        _metrics.counter("attention.decode.plain").inc()
        valid = (torch.arange(Smax, device=pos.device)[None, :]
                 <= pos[:, None])[:, None, :]                  # (B,1,Smax)
        o = _sdpa(q, cache_k, cache_v, valid, cfg)
    y = einsum("bshk,hkd->bsd", o, p["wo"])
    return constrain(y, ("batch", None, None))


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU) + binary (±1) variant
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    D, Ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": Spec((D, 2, Ff), ("embed", None, "mlp")),
                "wo": Spec((Ff, D), ("mlp", "embed"))}
    return {"wi": Spec((D, Ff), ("embed", "mlp")),
            "wo": Spec((Ff, D), ("mlp", "embed"))}


class _SignSTE(torch.autograd.Function):
    """sign(x) in {-1, +1} (0 maps to +1); the backward passes the
    gradient where ``|x| <= 1`` (the XNOR-Net straight-through clip)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def _sign_ste(x):
    return _SignSTE.apply(x)


def apply_mlp(p, cfg: ModelConfig, x):
    acc = wide(x.dtype)
    if cfg.binary_ffn:
        # MatPIM §II-B as a layer: the signs of the activations times the
        # signs of the weights, as float32 products of ±1 values (each sum
        # of ±1 terms is an exact integer in float32). No kernel of the
        # port computes it, as none of the reference's does.
        xb = _sign_ste(x.to(acc))
        if cfg.act == "swiglu":
            wb = _sign_ste(p["wi"].to(acc))
            h = einsum("bsd,dcf->bcsf", xb, wb)
            h = F.silu(h[:, 0]) * h[:, 1]
        else:
            h = _gelu(einsum("bsd,df->bsf", xb,
                                   _sign_ste(p["wi"].to(acc))))
        h = constrain(h.to(x.dtype), ("batch", None, "mlp"))
        y = einsum("bsf,fd->bsd", _sign_ste(h.to(acc)),
                         _sign_ste(p["wo"].to(acc))).to(x.dtype)
        return constrain(y, ("batch", None, None))
    if cfg.act == "swiglu":
        h = einsum("bsd,dcf->bcsf", x, p["wi"])
        h = (F.silu(h[:, 0].to(acc)) * h[:, 1].to(acc)).to(x.dtype)
    else:
        h = einsum("bsd,df->bsf", x, p["wi"])
        h = _gelu(h.to(acc)).to(x.dtype)
    h = constrain(h, ("batch", None, "mlp"))
    y = einsum("bsf,fd->bsd", h, p["wo"])
    return constrain(y, ("batch", None, None))


# ---------------------------------------------------------------------------
# MoE: router + GShard-style capacity dispatch
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig):
    D, Ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    wi_shape = (E, D, 2, Ff) if cfg.act == "swiglu" else (E, D, Ff)
    wi_axes = ("experts", "embed", None, "mlp") if cfg.act == "swiglu" \
        else ("experts", "embed", "mlp")
    return {
        "router": Spec((D, E), ("embed", "experts"), dtype="float32"),
        "wi": Spec(wi_shape, wi_axes),
        "wo": Spec((E, Ff, D), ("experts", "mlp", "embed")),
    }


MOE_GROUP = 4096  # tokens routed per group (keeps dispatch O(T), GShard-style)


def apply_moe(p, cfg: ModelConfig, x):
    """Top-k routing with per-expert capacity *per token group* (GShard);
    dropped tokens pass through (residual). The dispatch tensor is
    (G, Tg, E, C) with C = k·Tg·cf/E — linear in total tokens. Dispatch
    and combine are bfloat16, as in the reference (0/1 entries, and the
    renormalised gates rounded to bfloat16)."""
    acc = wide(x.dtype)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    T = B * S
    Tg = min(MOE_GROUP, T)
    G = T // Tg
    xt = reshape(x, G, Tg, D)
    xt = constrain(xt, ("batch", None, None))
    logits = einsum("gtd,de->gte", xt.to(acc), p["router"].to(acc))
    # torch's softmax: topk below needs the whole experts axis anyway
    gates = torch.softmax(logits, dim=-1)
    topg, topi = torch.topk(gates, k, dim=-1)                 # (G, Tg, k)
    topg = topg / torch.clamp(topg.sum(-1, keepdim=True), min=1e-9)

    C = max(int(k * Tg * cfg.capacity_factor / E), 1)
    # rank of each (token, slot) within its expert's queue, per group
    onehot = F.one_hot(topi, E).to(torch.int32)               # (G,Tg,k,E)
    flat = reshape(onehot, G, Tg * k, E)
    ranks = reshape(torch.cumsum(flat, dim=1) - flat, G, Tg, k, E)
    rank = (ranks * onehot).sum(-1)                           # (G, Tg, k)
    keep = rank < C
    bf16 = torch.bfloat16
    disp = (onehot * keep[..., None]).to(bf16)
    pos_oh = F.one_hot(torch.clamp(rank, 0, C - 1).long(), C).to(bf16)
    dispatch = einsum("gtke,gtkc->gtec", disp, pos_oh)
    combine = einsum("gtke,gtkc,gtk->gtec", disp, pos_oh,
                           topg.to(bf16))
    # the reference's mixed-dtype einsums promote to x's dtype; the 0/1
    # dispatch entries and bf16 gates are exact in it
    xe = einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xt)
    xe = constrain(xe, ("batch", "experts", None, None))
    if cfg.act == "swiglu":
        h = einsum("gecd,edzf->gezcf", xe, p["wi"])
        h = (F.silu(h[:, :, 0].to(acc))
             * h[:, :, 1].to(acc)).to(x.dtype)
    else:
        h = _gelu(einsum("gecd,edf->gecf", xe,
                               p["wi"]).to(acc)).to(x.dtype)
    h = constrain(h, ("batch", "experts", None, "mlp"))
    ye = einsum("gecf,efd->gecd", h, p["wo"])
    y = einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)
    return constrain(reshape(y, B, S, D), ("batch", None, None))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig):
    V = cfg.vocab_padded
    s = {"tok": Spec((V, cfg.d_model), ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        s["unembed"] = Spec((cfg.d_model, V), ("embed", "vocab"))
    return s


def _lookup(table, ids):
    """``table[ids]``. On a DTensor table whose vocab is split over mesh
    axes (``vocab`` over 'model'), each rank looks up the ids that fall in
    its own block of rows and gives zeros for the rest, and the blocks add
    up: a ``Partial`` sum over those axes (Megatron's vocab-parallel
    embedding, a ``local_map``). The table's other split (FSDP of
    'embed' over 'data') is gathered first. DTensor's own ``index`` on a
    split table routes its backward through an ``index_put`` whose
    sharding rule torch 2.11 refuses on the card."""
    if not isinstance(table, DTensor):
        return table[ids]
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tpl = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate()
                for q in table.placements)
    vocab = [isinstance(q, Shard) for q in tpl]
    ids = as_dtensor(ids, mesh)
    ipl = tuple(Replicate() if v or not (isinstance(q, Shard) and q.dim == 0)
                else q for v, q in zip(vocab, ids.placements))
    out_pl = [Partial() if v else q for v, q in zip(vocab, ipl)]
    # each rank's table gradient holds only its own ids' rows: a pending
    # sum over the mesh axes that split the ids
    grad_pl = tuple(Partial() if isinstance(q, Shard) else t
                    for t, q in zip(tpl, ipl))
    table = redistribute(table, tpl)
    v0 = shard_offset(table, 0)

    def local(t, i):
        at = i - v0
        inside = (at >= 0) & (at < t.shape[0])
        rows = t[at.clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
    return local_map(local, out_placements=out_pl, in_placements=(tpl, ipl),
                     in_grad_placements=(grad_pl, ipl),
                     device_mesh=mesh)(table, redistribute(ids, ipl))


def embed(p, cfg: ModelConfig, ids):
    y = _lookup(p["tok"], ids)
    return constrain(y, ("batch", None, None))


def unembed(p, cfg: ModelConfig, x):
    acc = wide(x.dtype)
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    logits = einsum("bsd,dv->bsv", x, w).to(acc)
    return constrain(logits, ("batch", None, "vocab"))


__all__ = ["MOE_GROUP", "apply_mlp", "apply_moe", "apply_norm",
           "apply_rope", "attention", "attention_decode", "attn_specs",
           "cross_attention", "embed", "embed_specs", "mlp_specs",
           "moe_specs", "norm_specs", "unembed"]
