"""Model assembly for every assigned architecture family, the port of
``src/repro/models/lm.py``.

One generic :class:`Model` covers:
  dense / moe / vlm — decoder-only stacks (uniform or periodic layer groups)
  ssm               — mamba2 (attention-free)
  hybrid            — jamba (mamba + attn 1:7, MoE every 2nd layer),
                      granite-4.0-h-micro (mamba + attn 1:9, a port-only
                      config: μP multipliers, ``_embed``, ``_residual``,
                      ``_logits``)
  encdec            — whisper (bidirectional encoder + causal decoder w/ cross)

A group is the smallest periodic pattern of sublayers (period =
lcm(attn_every, moe_every)); parameters are stacked over groups, and the
reference's ``lax.scan`` over groups becomes a loop over the stacked group
axis. Caches come back stacked over groups, as the scan returns them;
a decode step updates the cache in place, each sublayer its own slice
(:meth:`Model.decode_step`), and on the card :class:`DecodeGraph` replays
one from a CUDA graph. :class:`Model` alone knows the cache's format
(:meth:`Model._cache_specs`, :meth:`Model.write_slot`).

The model is functional, like the reference's: parameters (a tree from
:func:`~repro_torch.models.spec.init_params` or
:func:`~repro_torch.models.spec.params_from_numpy`) are passed to every
call. Inputs:
  tokens (B,S) int64
  frames (B,enc_seq,D)      — whisper stub frontend (precomputed embeddings)
  patch_embeds (B,n_patch,D)— qwen2-vl stub frontend
"""
from __future__ import annotations

import functools
import math
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from ..distributed.sharding import (as_dtensor, constrain, current_mesh,
                                     current_rules, redistribute, use_mesh,
                                     write_block)
from ..distributed.spmd import einsum, reshape
from ..kernels import decode_attention as _decode
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs.trace import span as _span
from . import layers as L
from . import mamba as M
from .spec import (Spec, axes_tree, is_spec, stack_specs, torch_dtype,
                   tree_leaves, tree_map, wide)

N_PATCHES = 256  # vlm stub: image patches prepended to the text sequence

# activation checkpointing policies, the reference's: "full" recomputes a
# layer group's forward in the backward pass, "dots" keeps the products
# without a batch dimension and recomputes the rest, "none" keeps all
REMAT = ("none", "full", "dots")

_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save
    the output of a matrix product with no batch dimension, recompute
    everything else. ``torch.einsum`` lowers a product with no batch
    dimension (``"bsd,dhk->bshk"``) to ``aten.bmm`` with a batch of one, so
    that counts as one; ``aten.bmm`` over a real batch (the attention
    scores and their weighted sum) is recomputed."""
    if op in _MM or (op is torch.ops.aten.bmm.default
                     and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def _group(tree, g: int):
    """Group ``g`` of a tree stacked over groups."""
    return tree_map(lambda a: a[g], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` groups of a tree stacked over groups, each leaf unbound
    once: one backward node per leaf stacks the groups' gradients, where
    a slice per group would add ``n`` full-size gradients."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    parts = [_unstack(t, n) for t in tree]
    return [type(tree)(p[g] for p in parts) for g in range(n)]


def _set_state(dst, new) -> int:
    """Copy a Mamba layer's ``new`` state into ``dst``, its slice of the
    cache: on a DTensor slice, into its local shard, ``new`` brought to the
    slice's placements first. Returns the bytes copied."""
    if isinstance(dst, DTensor):
        new = redistribute(as_dtensor(new, dst.device_mesh),
                           dst.placements).to_local()
        dst = dst.to_local()
    dst.copy_(new)
    return new.nbytes


def _residual(cfg: ModelConfig, x, y):
    """``x + y``, the branch ``y`` scaled by μP's ``residual_multiplier``
    first where the config sets one."""
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return x + y


def _stack(trees: list):
    """Stack a list of same-structure trees along a new leading axis (the
    group axis the reference's scan stacks its outputs on)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return type(first)(_stack([t[i] for t in trees])
                       for i in range(len(first)))


class Model(torch.nn.Module):
    """One architecture family's stack. ``remat`` (``"none" | "full" |
    "dots"``) is the reference's activation checkpointing of each layer
    group's body (and the encoder's), applied where gradients are on:
    ``"full"`` wraps the body in ``torch.utils.checkpoint.checkpoint``
    (``use_reentrant=False``), ``"dots"`` adds :func:`_dots_policy` as a
    selective-checkpoint policy. Under either the checkpointed body
    returns only the hidden state, so the forward returns no cache (a
    body that returned each group's K/V would keep them alive until the
    backward pass). Under ``no_grad`` (serving: ``decode_step``,
    ``Engine``) every value runs as ``"none"``; the values computed are
    the same under all three."""

    def __init__(self, cfg: ModelConfig, remat: str = "none"):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat={remat!r}: expected one of {REMAT}")
        self.cfg = cfg
        self.remat = remat
        if cfg.family == "ssm":
            self.period = 1
            self.kinds = [("mamba", "none")]
        elif cfg.family == "hybrid":
            p = _lcm(cfg.attn_every or 1, cfg.moe_every or 1)
            self.period = p
            self.kinds = [("attn" if cfg.is_attn_layer(i) else "mamba",
                           "moe" if cfg.is_moe_layer(i) else "mlp")
                          for i in range(p)]
        else:
            p = cfg.moe_every if cfg.n_experts else 1
            self.period = p
            self.kinds = [("attn", "moe" if cfg.is_moe_layer(i) else "mlp")
                          for i in range(p)]
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.n_layers} layers is not a multiple of "
                             f"the period {self.period}")
        self.n_groups = cfg.n_layers // self.period

    # -- specs ----------------------------------------------------------------

    def _sublayer_specs(self, mixer: str, ffn: str) -> Dict[str, Any]:
        cfg = self.cfg
        s: Dict[str, Any] = {"norm1": L.norm_specs(cfg)}
        if mixer == "attn":
            s["attn"] = L.attn_specs(cfg)
        else:
            s["mamba"] = M.mamba_specs(cfg)
        if ffn != "none":
            s["norm2"] = L.norm_specs(cfg)
            if ffn == "moe":
                s["moe"] = L.moe_specs(cfg)
                if cfg.dense_ff:
                    s["dense_mlp"] = L.mlp_specs(cfg, cfg.dense_ff)
            else:
                s["mlp"] = L.mlp_specs(cfg)
        return s

    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        group = {f"sub{i}": self._sublayer_specs(mx, ff)
                 for i, (mx, ff) in enumerate(self.kinds)}
        s: Dict[str, Any] = {
            "embed": L.embed_specs(cfg),
            "final_norm": L.norm_specs(cfg),
            "layers": stack_specs(group, self.n_groups, "layers"),
        }
        if cfg.family == "encdec":
            enc_group = {"sub0": {"norm1": L.norm_specs(cfg),
                                  "attn": L.attn_specs(cfg),
                                  "norm2": L.norm_specs(cfg),
                                  "mlp": L.mlp_specs(cfg)}}
            s["encoder"] = stack_specs(enc_group, cfg.enc_layers, "layers")
            s["enc_final_norm"] = L.norm_specs(cfg)
            # decoder cross-attention, one per decoder layer group
            s["cross"] = stack_specs(
                {"norm": L.norm_specs(cfg),
                 "attn": L.attn_specs(cfg, cross=True)},
                self.n_groups, "layers")
        if cfg.family == "vlm":
            s["patch_proj"] = {"w": Spec((cfg.d_model, cfg.d_model),
                                         ("embed", None))}
        return s

    # -- position helpers -----------------------------------------------------

    def _positions(self, B: int, S: int, device, offset=0):
        pos = torch.arange(S, device=device)[None, :] + offset
        return pos.expand(B, S)

    def _positions3(self, B: int, S: int, device):
        """VLM M-RoPE stub: patches get an (h, w) grid at t=0; text tokens
        get t=h=w=absolute-position (so decode_step's (pos,pos,pos) rotary
        stream is consistent with prefill)."""
        side = int(math.sqrt(N_PATCHES))
        n_p = min(N_PATCHES, S)
        ar = torch.arange(n_p, device=device)
        text = torch.arange(n_p, S, device=device)
        t = torch.cat([torch.zeros(n_p, dtype=torch.long, device=device),
                       text])
        hh = torch.cat([ar // side, text])
        ww = torch.cat([ar % side, text])
        p3 = torch.stack([t, hh, ww])                         # (3, S)
        return p3[:, None, :].expand(3, B, S)

    # -- sublayer application -------------------------------------------------

    def _apply_sublayer(self, p, kind, x, pos, positions3, *, decode=False,
                        cache=None, cross_kv=None):
        cfg = self.cfg
        mixer, ffn = kind
        new_cache = None
        h = L.apply_norm(p["norm1"], cfg, x)
        if mixer == "attn":
            if decode:
                y = L.attention_decode(p["attn"], cfg, h, cache["k"],
                                       cache["v"], pos)
            else:
                y, (k, v) = L.attention(p["attn"], cfg, h, pos, causal=True,
                                        positions3=positions3)
                new_cache = {"k": k, "v": v}
        else:
            S = h.shape[1]
            with _span("model.mamba", tokens=h.shape[0] * S,
                       tail=0 if decode else M.tail_rows(S, M.CHUNK)):
                if decode:
                    y, conv, ssm = M.apply_mamba_step(
                        p["mamba"], cfg, h, cache["conv"], cache["ssm"])
                    _metrics.counter("mamba.decode.state_copy_bytes").inc(
                        _set_state(cache["conv"], conv)
                        + _set_state(cache["ssm"], ssm))
                else:
                    y, new_cache = M.apply_mamba(p["mamba"], cfg, h)
        x = _residual(cfg, x, y)
        if cross_kv is not None:
            h = L.apply_norm(p["cross_norm"], cfg, x)
            x = x + L.cross_attention(p["cross_attn"], cfg, h, cross_kv)
        if ffn != "none":
            h = L.apply_norm(p["norm2"], cfg, x)
            if ffn == "moe":
                y = L.apply_moe(p["moe"], cfg, h)
                if cfg.dense_ff:
                    y = y + L.apply_mlp(p["dense_mlp"], cfg, h)
            else:
                y = L.apply_mlp(p["mlp"], cfg, h)
            x = _residual(cfg, x, y)
        return x, new_cache

    def _checkpoints(self) -> bool:
        """Whether group bodies run checkpointed: a remat policy is set
        and gradients are on."""
        return self.remat != "none" and torch.is_grad_enabled()

    def _checkpoint(self, body, x):
        """``body(x)``, a group's hidden state to the next, checkpointed
        under the model's policy. The recompute runs in the backward, on
        the autograd engine's thread for the card's tensors, where this
        thread's ``use_mesh`` is not active: it re-enters the mesh and
        rules active now, or DTensor places its operands otherwise than
        the forward did."""
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        mesh, rules = current_mesh(), current_rules()

        def run(h):
            with use_mesh(mesh, rules):
                return body(h)
        return checkpoint(run, x, use_reentrant=False, **kw)

    def _groups(self, params, x, pos, positions3, cache=None,
                cross_kv=None):
        """The reference's scan over layer groups, as a loop: returns the
        hidden state and, for a forward, the per-group caches stacked over
        groups (none when the groups run checkpointed,
        :meth:`_checkpoints`). A decode step (``cache`` given) has each
        sublayer write its new cache into its slice of ``cache``, and
        returns no cache."""
        decode = cache is not None
        n = self.n_groups
        layers = _unstack(params["layers"], n)
        caches = _unstack(cache, n) if decode else [None] * n
        ckvs = _unstack(cross_kv, n) if cross_kv is not None else [None] * n
        cross = (_unstack(params["cross"], n) if cross_kv is not None
                 else [None] * n)

        def body(g, x):
            new_caches = {}
            for i, kind in enumerate(self.kinds):
                p = dict(layers[g][f"sub{i}"])
                use_cross = ckvs[g] is not None and i == 0
                if use_cross:
                    p["cross_norm"] = cross[g]["norm"]
                    p["cross_attn"] = cross[g]["attn"]
                x, new_caches[f"sub{i}"] = self._apply_sublayer(
                    p, kind, x, pos, positions3, decode=decode,
                    cache=caches[g][f"sub{i}"] if decode else None,
                    cross_kv=ckvs[g] if use_cross else None)
            return x, new_caches

        if not decode and self._checkpoints():
            for g in range(n):
                x = self._checkpoint(lambda h, g=g: body(g, h)[0], x)
            return x, None
        per_group = []
        for g in range(n):
            with _span("model.group", g=g):
                x, c = body(g, x)
            per_group.append(c)
        return x, None if decode else _stack(per_group)

    # -- encoder (whisper) ----------------------------------------------------

    def encode(self, params, frames):
        cfg = self.cfg
        B, S, D = frames.shape
        pos = self._positions(B, S, frames.device)
        # sinusoidal positions on top of the (stub) conv frontend output
        x = frames + _sinusoid(S, D, frames.dtype, frames.device)[None]
        for lp in _unstack(params["encoder"], cfg.enc_layers):
            def body(h, p=lp["sub0"]):
                y = L.apply_norm(p["norm1"], cfg, h)
                y, _ = L.attention(p["attn"], cfg, y, pos, causal=False)
                h = h + y
                y = L.apply_norm(p["norm2"], cfg, h)
                return h + L.apply_mlp(p["mlp"], cfg, y)
            x = self._checkpoint(body, x) if self._checkpoints() else body(x)
        return L.apply_norm(params["enc_final_norm"], cfg, x)

    def encoder_kv(self, params, enc_out):
        """Per-decoder-layer-group cross K/V from the encoder output:
        ``(k, v)``, each (groups, B, S, KV, hd)."""
        attn = params["cross"]["attn"]
        k = einsum("bsd,ldhk->lbshk", enc_out, attn["wk"])
        v = einsum("bsd,ldhk->lbshk", enc_out, attn["wv"])
        # pinned to the decode cache's placement of the cross K/V
        # (cache_axes): DTensor's einsum strategy may otherwise shard the
        # group axis, which the loop over groups unbinds
        ax = self.cache_axes()["cross_kv"][0]
        return constrain(k, ax), constrain(v, ax)

    # -- forward (train / prefill) --------------------------------------------

    def forward(self, params, batch) -> Tuple[torch.Tensor, Any]:
        """Returns (logits, cache). Cache leaves are stacked over groups;
        the cache is ``None`` where the groups run checkpointed (a remat
        policy with gradients on)."""
        with _span("model.forward", tokens=batch["tokens"].numel()):
            cfg = self.cfg
            tokens = batch["tokens"]
            B, S = tokens.shape
            dev = tokens.device
            x = self._embed(params, tokens)
            positions3 = None
            if cfg.family == "vlm":
                patches = einsum("bpd,de->bpe", batch["patch_embeds"],
                                 params["patch_proj"]["w"]).to(x.dtype)
                n_p = patches.shape[1]
                x = torch.cat([patches, x[:, :S - n_p]], dim=1)
                positions3 = self._positions3(B, S, dev)
            pos = self._positions(B, S, dev)

            cross_kv = None
            if cfg.family == "encdec":
                enc_out = self.encode(params, batch["frames"])
                cross_kv = self.encoder_kv(params, enc_out)
                x = x + _sinusoid(S, cfg.d_model, x.dtype, dev)[None]

            x, caches = self._groups(params, x, pos, positions3,
                                     cross_kv=cross_kv)
            return self._logits(params, x), caches

    def _embed(self, params, tokens):
        """The tokens' rows of the table, times μP's
        ``embedding_multiplier`` where the config sets one."""
        x = L.embed(params["embed"], self.cfg, tokens)
        m = self.cfg.embedding_multiplier
        return x * m if m != 1.0 else x

    def _logits(self, params, x):
        """The final norm and the unembedding, the logits divided by μP's
        ``logits_scaling`` where the config sets one."""
        x = L.apply_norm(params["final_norm"], self.cfg, x)
        logits = L.unembed(params["embed"], self.cfg, x)
        d = self.cfg.logits_scaling
        return logits / d if d != 1.0 else logits

    # -- decode ---------------------------------------------------------------

    def _cache_specs(self, B: int, S_max: int, dtype,
                     enc_seq: Optional[int] = None):
        """The cache's format, which :meth:`init_cache` and
        :meth:`cache_axes` read: a tree of :class:`~.spec.Spec` stacked
        over groups, each leaf's shape, logical axes and dtype. A
        sublayer's cache by its mixer: attention's K and V rows, a Mamba
        layer's conv tail and SSM state (the state in ``wide(dtype)``);
        whisper's cross K/V beside the layers."""
        cfg = self.cfg

        def sublayer(mixer):
            if mixer == "attn":
                kv = Spec((B, S_max, cfg.n_kv_heads, cfg.hd),
                          ("batch", "cache_seq", "kv_heads", None),
                          dtype=dtype)
                return {"k": kv, "v": kv}
            ch = cfg.di + 2 * cfg.ssm_state
            return {"conv": Spec((B, cfg.conv_dim - 1, ch),
                                 ("batch", None, "d_inner"), dtype=dtype),
                    "ssm": Spec((B, cfg.ssm_heads, cfg.ssm_headdim,
                                 cfg.ssm_state), ("batch", None, None, None),
                                dtype=wide(dtype))}
        group = {f"sub{i}": sublayer(mixer)
                 for i, (mixer, _) in enumerate(self.kinds)}
        specs = {"layers": stack_specs(group, self.n_groups)}
        if cfg.family == "encdec":
            cross = Spec((B, enc_seq or cfg.enc_seq, cfg.n_kv_heads, cfg.hd),
                         ("batch", None, "kv_heads", None), dtype=dtype)
            specs["cross_kv"] = stack_specs((cross, cross), self.n_groups)
        return specs

    def init_cache(self, B: int, S_max: int, dtype=torch.bfloat16,
                   enc_seq: Optional[int] = None, device="cuda"):
        """Zero caches, stacked over groups, on ``device`` (the card unless
        another device is asked for; raises without CUDA)."""
        device = resolve_device(device)
        return tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            self._cache_specs(B, S_max, torch_dtype(dtype), enc_seq),
            is_spec)

    def cache_axes(self):
        """Logical sharding axes matching init_cache."""
        return axes_tree(self._cache_specs(1, 1, torch.float32))

    def write_slot(self, cache, prefill, slot: int) -> None:
        """Set one request's prefill cache (:meth:`forward`'s, batch 1)
        into batch slot ``slot`` of ``cache``, each leaf's block from the
        slot's origin: attention's rows up to the prompt's length, a Mamba
        layer's states whole. A set, so a recycled slot keeps no stale row
        that the decode mask would let through; on a DTensor cache each
        rank writes its own part (:func:`write_block`)."""
        for dst, src in zip(tree_leaves(cache["layers"]),
                            tree_leaves(prefill)):
            write_block(dst, (slice(None), slot)
                        + tuple(slice(0, n) for n in src.shape[2:]),
                        src[:, 0])

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B,1); pos (B,) write index. Returns (logits, cache).

        Where the reference's jitted step takes the cache donated and
        returns a new one, the port updates the cache in place and returns
        the cache object it was given, plain or DTensor: each attention
        sublayer sets its new K/V row into its slice, each Mamba sublayer
        copies its new states into theirs, and nothing of the cache is
        copied whole."""
        with _span("model.decode_step", batch=tokens.shape[0]):
            cfg = self.cfg
            pos = pos.long()
            x = self._embed(params, tokens)
            if cfg.family == "encdec":
                x = x + _sinusoid_at(pos, cfg.d_model, x.dtype)[:, None, :]
            positions3 = None  # vlm decode: text-only continuation (stub)
            x, _ = self._groups(params, x, pos, positions3,
                                cache=cache["layers"],
                                cross_kv=cache.get("cross_kv"))
            return self._logits(params, x), cache


# what a decode step's host code counts outside the metrics registry
_LAUNCHES = "decode_attention.launches"


def _tallies() -> Dict[str, float]:
    """Every counter of :mod:`repro_torch.obs.metrics` by name, and
    ``decode_attention``'s launches under :data:`_LAUNCHES`."""
    reg = _metrics.registry()
    out = {n: reg.get(n).value for n in reg.names()
           if isinstance(reg.get(n), _metrics.Counter)}
    out[_LAUNCHES] = _decode.decode_attention.launches
    return out


def _add_tally(name: str, n) -> None:
    if name == _LAUNCHES:
        _decode.decode_attention.launches += n
    else:
        _metrics.counter(name).inc(n)


class DecodeGraph:
    """:meth:`Model.decode_step` over a fixed cache on the card, captured
    once in a CUDA graph and replayed for every step: the host issues one
    graph launch where it issued each layer's operations.

    It owns the static inputs, ``tokens`` (B, 1) and ``pos`` (B,) (the two
    rows of one int64 buffer, ``feed``, filled by one copy a step), the
    graph, and the static ``logits`` each replay writes. The step runs
    once on a side stream first (every ``decode_attention`` variant built,
    every launch plan and cached index made), then is captured on it; both
    run on the zero cache, before any slot is live, and the cache is zeroed
    again after them. The graph holds the cache's and the parameters'
    addresses: the cache is written in place from then on (a prefill's
    handoff by :meth:`Model.write_slot`, a step by the graph).

    Host code in the step runs at capture only, so each replay adds what
    the capture counted (``attention.decode.kernel``,
    ``mamba.decode.state_copy_bytes``, ``decode_attention.launches``, ...)
    and records one ``model.decode_step`` span (``batch``, ``graph=1``);
    the warm-up's and the capture's own counts are taken back, and no span
    is recorded while they run. ``capture_s`` is their host seconds.

    :meth:`takes` says which caches it is for: every leaf a plain tensor
    (not a DTensor) on the card, of a dtype the decode kernel takes.
    A DTensor cache (sequence split over ranks), the CPU and a float64
    precision reference decode eagerly."""

    @staticmethod
    def takes(cache) -> bool:
        return all(not isinstance(t, DTensor) and t.is_cuda
                   and t.dtype in _decode.DTYPES for t in tree_leaves(cache))

    def __init__(self, model: Model, params, cache):
        t0 = time.perf_counter()
        leaf = tree_leaves(cache)[0]
        dev = leaf.device
        self.batch = leaf.shape[1]              # (groups, B, ...)
        self.feed = torch.zeros((2, self.batch), dtype=torch.long,
                                device=dev)
        self.tokens, self.pos = self.feed[0][:, None], self.feed[1]
        before = _tallies()
        tracer = _trace.disable()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                model.decode_step(params, cache, self.tokens, self.pos)
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = _tallies()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                self.logits, _ = model.decode_step(params, cache,
                                                   self.tokens, self.pos)
            after = _tallies()
        finally:
            if tracer is not None:
                _trace.enable(tracer)
        self.counts = {n: v - warm.get(n, 0) for n, v in after.items()
                       if v != warm.get(n, 0)}
        for n, v in after.items():
            _add_tally(n, before.get(n, 0) - v)
        for t in tree_leaves(cache):
            t.zero_()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> torch.Tensor:
        """One decode step on what ``feed`` holds; returns the static
        logits (B, 1, V), overwritten by the next replay."""
        with _span("model.decode_step", batch=self.batch, graph=1):
            self.graph.replay()
        for n, v in self.counts.items():
            _add_tally(n, v)
        return self.logits


def _sinusoid(S: int, D: int, dtype, device=None):
    pos = torch.arange(S, dtype=wide(dtype), device=device)[:, None]
    return _sinusoid_table(pos, D, dtype)


def _sinusoid_at(pos, D: int, dtype):
    return _sinusoid_table(pos.to(wide(dtype))[:, None], D, dtype)


def _sinusoid_table(pos, D: int, dtype):
    acc = wide(dtype)
    dim = torch.arange(0, D, 2, dtype=acc, device=pos.device)[None, :]
    ang = pos / torch.pow(10000.0, dim / D)
    # sin and cos interleaved (even and odd columns); a stack, not an
    # assignment into a new tensor, so a DTensor ``pos`` stays one
    out = reshape(torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1),
                  pos.shape[0], D)
    return out.to(dtype)


def build_model(cfg: ModelConfig, remat: str = "none") -> Model:
    return Model(cfg, remat)


__all__ = ["DecodeGraph", "Model", "N_PATCHES", "build_model"]
