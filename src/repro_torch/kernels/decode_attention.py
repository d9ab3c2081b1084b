"""Decode attention: one query row of every batch slot against the valid
rows of its KV cache, split-K flash decoding on the GPU.

Replaces no TPU kernel. The reference decodes through XLA, which fuses the
masked softmax of ``src/repro/models/layers.py::_sdpa`` over the whole
cache; eager PyTorch cannot, and the port's ``_sdpa`` widened each layer's
whole cache to float32 and laid it out again for its two einsums at every
decode step. :func:`decode_attention` computes the same function, q
``(B, 1, H, hd)`` against k and v ``(B, S_max, KV, hd)`` at the rows ``s <=
pos[b]`` of each slot ``b``: CUDA tensors go to the hand-written kernel in
``csrc/decode_attention.cu``, CPU tensors to :func:`decode_attention_plain`,
the same function in plain PyTorch. There is no fallback from one to the
other.

The function is the operator ``torch.ops.repro_torch.decode_attention``,
so that what sees operators sees it whole: on ``meta`` and fake tensors
it gives an empty result of q's shape (the dry run's peak holds no
temporaries of the plain version), and ``FlopCounterMode`` (with the dry
run's meter) counts it by :func:`_flops`, the same count on the card as
on ``meta``. Each variant of the CUDA source (:func:`variant`: the cache's
dtype, the query heads a CTA takes, the vectors a lane holds) builds into
a library of its own at its first launch, one kernel pair for ``nvcc``.

The arithmetic is ``_sdpa``'s: float32 logits divided by ``scale``
(``sqrt(hd)`` unless the model's ``attention_multiplier`` sets another,
``layers.logit_divisor``), rows past ``pos`` out of the softmax (the
reference's ``-1e30`` gives them weight 0 exactly), a float32 softmax and
weighted sum, the result in q's dtype.

What bounds it. Device memory: the rows at or below ``pos``, read once
(``bytes_needed``), against 2 FMAs per element read for each query head
sharing the row. At the chat shape (32 slots, 16 KV heads of 128, bf16,
about 720 valid rows a slot) that is 189 MB a layer, 56 us at 3.35 TB/s.
The kernel reads each valid row once in 16-byte loads, for all the query
heads of its KV head, and never reads a row past ``pos``.
:func:`decode_launch_plan` splits each slot's rows into chunks so that at
least ``TARGET_CTAS`` CTAs run; with more than one chunk a second short
kernel merges the chunks' partial maxima, sums and accumulators.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import MIN_CTAS, Signature, launch

SOURCE = "decode_attention.cu"
SYMBOL = "matpim_decode_attention"
DTYPES = (torch.float32, torch.bfloat16)

# The launch plan's constants, for the H100 SXM.
TARGET_CTAS = 2 * MIN_CTAS   # at least two CTAs an SM
MIN_CHUNK_ROWS = 128         # rows a chunk keeps at least
MAX_HEADS = 8                # query heads a CTA takes
HD_RANGE = (16, 256)         # head sizes taken, multiples of 8


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class DecodePlan(NamedTuple):
    """One launch: ``chunks`` CTAs of ``chunk_rows`` rows for each slot and
    each of ``groups`` groups of ``rb`` query heads of a KV head, ``lanes``
    threads holding a row of ``nvec`` 16-byte vectors."""
    rb: int
    groups: int
    lanes: int
    nvec: int
    chunks: int
    chunk_rows: int


@functools.lru_cache(maxsize=256)
def decode_launch_plan(B: int, H: int, KV: int, S: int, hd: int,
                       c_dtype: torch.dtype) -> DecodePlan:
    """The split of one launch over ``B`` slots of ``H`` query heads on
    ``KV`` KV heads of ``hd``, a cache of ``S`` rows of ``c_dtype``.

    A CTA takes ``rb`` query heads of one KV head, the least power of two
    covering ``H / KV`` up to ``MAX_HEADS``. A row's ``lanes`` is the least
    power of two covering its 16-byte vectors, up to 32 (a float32 row of
    more than 128 elements gives each lane two). The chunks are the fewest
    that give ``TARGET_CTAS`` CTAs, but no more than leave each chunk
    ``MIN_CHUNK_ROWS`` rows."""
    rep = H // KV
    rb = min(MAX_HEADS, _pow2_at_least(rep))
    groups = -(-rep // rb)
    nvec = hd * c_dtype.itemsize // 16
    lanes = min(32, _pow2_at_least(nvec))
    ctas = B * KV * groups
    chunks = max(1, min(-(-TARGET_CTAS // max(ctas, 1)),
                        S // MIN_CHUNK_ROWS))
    chunk_rows = -(-S // chunks)
    return DecodePlan(rb=rb, groups=groups, lanes=lanes, nvec=nvec,
                      chunks=-(-S // chunk_rows), chunk_rows=chunk_rows)


def variant(c_dtype: torch.dtype, plan: DecodePlan) -> tuple:
    """The ``-D`` flags of the build of ``csrc/decode_attention.cu`` that
    runs ``plan`` on a cache of ``c_dtype``: its element type, the query
    heads a CTA takes and the 16-byte vectors of a row a lane holds."""
    tc = "__nv_bfloat16" if c_dtype == torch.bfloat16 else "float"
    return (f"-DDECODE_TC={tc}", f"-DDECODE_RB={plan.rb}",
            f"-DDECODE_VPL={-(-plan.nvec // plan.lanes)}")


class _Args(ctypes.Structure):
    """The kernel's launch arguments (``DecodeArgs`` in the CUDA source,
    same field order), packed once per signature and passed by address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "H", "KV", "S", "hd", "rep", "rb", "groups", "lanes", "nvec",
        "chunks", "chunk_rows", "c_bf16", "q_bf16")] + [
        ("scale", ctypes.c_float)]


def decode_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: ``_sdpa``'s arithmetic under the ``pos``
    mask (the logits divided by ``scale``, ``sqrt(hd)`` if None), in
    float32 (float64 for a float64 q). The rows past ``pos`` get
    weight 0 and their values are zeroed before the weighted sum, so
    whatever they hold (a stale slot's rows, NaN) never reaches the
    output, as the kernel never reads them."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    B, _, H, hd = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    valid = (torch.arange(S, device=pos.device)[None, :]
             <= pos[:, None])                                  # (B, S)
    qg = q.reshape(B, 1, KV, H // KV, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", qg.to(acc), cache_k.to(acc))
    logits = logits / (math.sqrt(hd) if scale is None else scale)
    logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    v = cache_v.to(acc).masked_fill(~valid[:, :, None, None], 0)
    out = torch.einsum("bkrqs,bskh->bqkrh", w, v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=256)
def _signature(q_shape, k_shape, v_shape, pos_shape, q_dtype, k_dtype,
               v_dtype, pos_dtype, scale=None) -> Signature:
    """The checks, output shape, refusal, scratch and packed launch
    arguments of one shape and dtype signature (a raise is not cached)."""
    if len(q_shape) != 4 or q_shape[1] != 1 or len(k_shape) != 4:
        raise ValueError(f"decode_attention takes q (B, 1, H, hd) and a "
                         f"cache (B, S, KV, hd); got {tuple(q_shape)} and "
                         f"{tuple(k_shape)}")
    B, _, H, hd = q_shape
    _, S, KV, khd = k_shape
    if (tuple(v_shape) != tuple(k_shape) or k_shape[0] != B or khd != hd
            or tuple(pos_shape) != (B,) or KV == 0 or H % KV):
        raise ValueError(f"decode_attention: q {tuple(q_shape)}, k "
                         f"{tuple(k_shape)}, v {tuple(v_shape)} and pos "
                         f"{tuple(pos_shape)} disagree")
    out_shape = tuple(q_shape)
    refusal = None
    if q_dtype not in DTYPES or k_dtype not in DTYPES or v_dtype != k_dtype:
        refusal = (f"decode_attention's kernel takes float32 or bfloat16 q "
                   f"and one of them for k and v; got {q_dtype}, {k_dtype}, "
                   f"{v_dtype}")
    elif pos_dtype != torch.int64:
        refusal = f"decode_attention takes int64 pos, got {pos_dtype}"
    elif hd % 8 or not HD_RANGE[0] <= hd <= HD_RANGE[1]:
        refusal = (f"decode_attention's kernel takes a head size that is a "
                   f"multiple of 8 in {list(HD_RANGE)}, got {hd}")
    elif max(B, S * KV * hd) >= 1 << 31 or B > 65535:
        refusal = (f"decode_attention shape {tuple(k_shape)} exceeds the "
                   f"kernel's index range")
    if refusal or B * H == 0 or S == 0:
        return Signature(out_shape, q_dtype, 0, refusal, None, 0)
    p = decode_launch_plan(B, H, KV, S, hd, k_dtype)
    args = _Args(B, H, KV, S, hd, H // KV, p.rb, p.groups, p.lanes, p.nvec,
                 p.chunks, p.chunk_rows, int(k_dtype == torch.bfloat16),
                 int(q_dtype == torch.bfloat16),
                 math.sqrt(hd) if scale is None else scale)
    scratch = B * KV * p.groups * p.chunks * p.rb * (hd + 2) \
        if p.chunks > 1 else 0
    return Signature(out_shape, q_dtype, B * H * hd, None, args,
                     ctypes.addressof(args), scratch, variant(k_dtype, p))


def _check(q, cache_k, cache_v, pos, scale) -> Signature:
    return _signature(q.shape, cache_k.shape, cache_v.shape, pos.shape,
                      q.dtype, cache_k.dtype, cache_v.dtype, pos.dtype, scale)


# the operator: defined with an implementation for CPU and CUDA tensors
# and a fake one for meta and fake tensors (torch.library.custom_op's
# wrapper would add ~20 us of host time a call, ~4 us this way)
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("decode_attention(Tensor q, Tensor cache_k, Tensor cache_v, "
            "Tensor pos, float? scale=None) -> Tensor")


def _run(q, cache_k, cache_v, pos, scale=None):
    sig = _check(q, cache_k, cache_v, pos, scale)
    if cache_k.is_cuda and (cache_k.data_ptr() | cache_v.data_ptr()) % 16:
        raise ValueError("decode_attention's kernel reads k and v in "
                         "16-byte vectors: their data must be 16-byte "
                         "aligned")
    out = launch(decode_attention, sig, q.contiguous(), cache_k, SOURCE,
                 SYMBOL, cache_v, pos)
    return decode_attention_plain(q, cache_k, cache_v, pos, scale) \
        if out is None else out


def _fake(q, cache_k, cache_v, pos, scale=None):
    _check(q, cache_k, cache_v, pos, scale)
    return q.new_empty(q.shape)


_LIB.impl("decode_attention", _run, "CPU")
_LIB.impl("decode_attention", _run, "CUDA")
torch.library.register_fake("repro_torch::decode_attention", _fake, lib=_LIB)
_OP = torch.ops.repro_torch.decode_attention.default


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, *args, **kwargs) -> int:
    """2 flops a cached element a query head for the logits and 2 for the
    weighted sum, over every row of the cache: on ``meta`` the rows below
    ``pos`` are unknown, so the count is the whole cache's, as
    ``_sdpa``'s einsums count it."""
    B, _, H, hd = q_shape
    return 4 * B * H * k_shape[1] * hd


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``(B, 1, H, hd)`` over the rows ``s <= pos[b]`` of
    k and v ``(B, S_max, KV, hd)`` (``pos`` int64 ``(B,)``, each in ``[0,
    S_max)``) → ``(B, 1, H, hd)`` in q's dtype, the logits divided by
    ``scale`` (``sqrt(hd)`` if None).

    CUDA tensors go to the kernel (one call; ``decode_attention.launches``
    counts calls), CPU tensors to :func:`decode_attention_plain`, ``meta``
    ones to an empty result of q's shape."""
    return _OP(q, cache_k, cache_v, pos, scale)


def bytes_needed(pos, KV: int, hd: int, itemsize: int, H: int,
                 q_itemsize: int) -> int:
    """The bytes a call must move: each slot's rows ``0..pos[b]`` of k and
    v, read once, q read and the output written once (``pos`` a sequence
    of ints)."""
    rows = sum(int(p) + 1 for p in pos)
    return 2 * rows * KV * hd * itemsize + 2 * len(pos) * H * hd * q_itemsize


decode_attention.launches = 0
