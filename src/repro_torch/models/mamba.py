"""Mamba-2 (SSD, state-space duality) block — chunked train/prefill scan +
O(1)-state decode step, the port of ``src/repro/models/mamba.py``.

    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t

Chunked algorithm: an intra-chunk quadratic attention-like term plus an
inter-chunk state recurrence, a loop over chunks where the reference runs
``lax.scan``. A sequence of any length is taken: a last chunk shorter
than the others (ragged) is padded with rows that neither decay nor add to
the state (:func:`ssd_plain`), where the reference asserts a multiple. On
plain CUDA tensors without gradients the scan is the hand-written kernel
``kernels/ssd_scan.py`` (:func:`ssd_chunked`), which masks those rows.
Under ``ssm_gated_norm`` the gated output ``y·silu(z)`` goes through
Mamba-2's RMSNorm and its weight before ``out_proj`` (:func:`_gate`).
The state scan is not a matvec-with-reduction shape, so the paper's
technique does not apply here (docs/ARCHITECTURE.md §Model stack).
The scan computes in float32 (float64 for a float64 model, :func:`.spec.wide`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from ..distributed.sharding import as_dtensor, constrain, redistribute
from ..distributed.spmd import cumsum, einsum, reshape
from ..kernels import ssd_scan as _scan
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .spec import Spec, wide

CHUNK = 256   # the SSD's chunk (Mamba-2's and Granite 4.0's chunk_size)


def mamba_specs(cfg: ModelConfig):
    D, DI = cfg.d_model, cfg.di
    H = cfg.ssm_heads
    N = cfg.ssm_state
    G = 1  # single B/C group
    conv_ch = DI + 2 * G * N
    s = {
        # in_proj produces [z (DI), x (DI), B (G*N), C (G*N), dt (H)]
        "in_proj": Spec((D, 2 * DI + 2 * G * N + H), ("embed", "d_inner")),
        "conv_w": Spec((cfg.conv_dim, conv_ch), (None, "d_inner")),
        "conv_b": Spec((conv_ch,), ("d_inner",), "zeros"),
        "A_log": Spec((H,), (None,), "zeros", dtype="float32"),
        "D": Spec((H,), (None,), "ones", dtype="float32"),
        "dt_bias": Spec((H,), (None,), "zeros", dtype="float32"),
        "out_proj": Spec((DI, D), ("d_inner", "embed")),
    }
    if cfg.ssm_gated_norm:
        s["norm"] = Spec((DI,), ("d_inner",), "ones")
    return s


def _split_proj(cfg: ModelConfig, zxbcdt):
    DI, G, N, H = cfg.di, 1, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [DI, DI, G * N, G * N, H], dim=-1)


_PROJ_BLOCKS = 4   # partial products of a float32 projection, added pairwise


def _proj(spec: str, x, w):
    """``einsum(spec, x, w)`` contracting ``x``'s last axis with
    ``w``'s first. In float32 the contraction runs as ``_PROJ_BLOCKS``
    partial products added pairwise. Torch's CPU BLAS sums a 64-wide contraction
    in one float32 chain, about 1.7x further from float64 than XLA's CPU
    dot (rms 1.4e-7 against 8.3e-8 on unit normals); the SSD stack grows
    the projections' rounding into the gradients, which sat 2.2x further
    from float64 than the reference's before the blocks and 0.9x after
    (``tests/test_torch_train.py``). Other dtypes take one product:
    bfloat16 partial sums would round each block."""
    k = w.shape[0]
    if x.dtype != torch.float32 or k % _PROJ_BLOCKS:
        return einsum(spec, x, w)
    step = k // _PROJ_BLOCKS
    parts = [einsum(spec, x[..., i:i + step], w[i:i + step])
             for i in range(0, k, step)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _causal_conv(x, w, b):
    """Depthwise causal conv via static shifts. x (B,S,C), w (K,C).

    On DTensors the conv runs on each rank's shard (a ``local_map``): it
    is per channel, so it needs the whole sequence and the channels of
    ``w`` and ``b`` that its block of ``x`` holds, nothing else. The
    sequence is gathered where it is split, and the weights follow the
    channel split of ``x``. (torch 2.11's DTensor ``pad`` fails to
    redistribute its input on the card.)"""
    if isinstance(x, DTensor):
        return _causal_conv_sharded(x, w, b)
    return _causal_conv_local(x, w, b)


def _causal_conv_sharded(x, w, b):
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    xpl = tuple(Replicate() if isinstance(q, Shard) and q.dim == 1 else q
                for q in x.placements)
    chan = [isinstance(q, Shard) and q.dim == 2 for q in xpl]
    wpl = tuple(Shard(1) if c else Replicate() for c in chan)
    bpl = tuple(Shard(0) if c else Replicate() for c in chan)
    # the weights' gradient on a rank holds its rows of the batch only
    rows = [isinstance(q, Shard) and q.dim == 0 for q in xpl]
    wgrad = tuple(Partial() if r else q for r, q in zip(rows, wpl))
    bgrad = tuple(Partial() if r else q for r, q in zip(rows, bpl))
    w, b = as_dtensor(w, mesh), as_dtensor(b, mesh)
    return local_map(_causal_conv_local, out_placements=list(xpl),
                     in_placements=(xpl, wpl, bpl),
                     in_grad_placements=(xpl, wgrad, bgrad),
                     device_mesh=mesh)(redistribute(x, xpl),
                                       redistribute(w, wpl),
                                       redistribute(b, bpl))


def _causal_conv_local(x, w, b):
    acc = wide(x.dtype)
    K = w.shape[0]
    out = x * w[-1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i, :]
        out = out + shifted * w[K - 1 - i]
    return F.silu((out + b).to(acc)).to(x.dtype)


def _segsum(dA):
    """dA (..., L) -> (..., L, L) lower-tri cumulative sums for the decay."""
    L = dA.shape[-1]
    cs = cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return diff.masked_fill(~mask, float("-inf"))


def tail_rows(s: int, chunk: int) -> int:
    """The rows of a ragged last chunk in a sequence of ``s``: none where
    the sequence fits one chunk or is a multiple of it."""
    return s % chunk if s > chunk else 0


def ssd_chunked(x, dt, A, B, C, D, chunk: int = CHUNK,
                init_state: Optional[torch.Tensor] = None):
    """x (b,s,h,p); dt (b,s,h) >0; A (h,) <0; B,C (b,s,n); D (h,).

    Returns y (b,s,h,p) and the final state (b,h,p,n).

    Where every operand is a plain CUDA tensor (no DTensor), x is float32
    or bfloat16 and no gradient is taken (grad mode off, or no operand
    requiring one), the scan is the hand-written kernel
    (:func:`~repro_torch.kernels.ssd_scan.ssd_scan`); everywhere else
    (the CPU, float64, DTensors, training) it is :func:`ssd_plain`. Both
    compute the same function in float32 (float64 for a float64 model,
    plain only). The calls of each are counted in ``mamba.ssd.kernel`` and
    ``mamba.ssd.plain``; the tokens and the rows a ragged last chunk lacks
    in ``mamba.ssd.tokens`` and ``mamba.ssd.pad_rows``, the same on both
    paths (always on); spanned by ``mamba.ssd`` (``tokens``,
    ``pad_rows``).
    """
    b, s = x.shape[:2]
    pad = -s % min(chunk, s)
    _metrics.counter("mamba.ssd.tokens").inc(b * s)
    _metrics.counter("mamba.ssd.pad_rows").inc(b * pad)
    with _span("mamba.ssd", tokens=b * s, pad_rows=b * pad):
        if _kernel_takes(x, dt, A, B, C, D, init_state):
            _metrics.counter("mamba.ssd.kernel").inc()
            return _scan.ssd_scan(x, dt, A, B, C, D, chunk, init_state)
        _metrics.counter("mamba.ssd.plain").inc()
        return ssd_plain(x, dt, A, B, C, D, chunk, init_state)


def _kernel_takes(x, *rest) -> bool:
    """Whether :func:`ssd_chunked` runs the kernel on these operands."""
    ops = (x,) + tuple(t for t in rest if t is not None)
    return (x.dtype in _scan.DTYPES
            and all(t.is_cuda and not isinstance(t, DTensor) for t in ops)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ops)))


def ssd_plain(x, dt, A, B, C, D, chunk: int = CHUNK,
              init_state: Optional[torch.Tensor] = None):
    """The plain PyTorch version of :func:`ssd_chunked`.

    A sequence of up to ``chunk`` rows is one chunk. A longer one that is
    not a multiple of ``chunk`` is padded to the next multiple with rows of
    ``dt`` = 0 and zero x, B, C: a padded row neither decays the state
    (``exp(0·A) = 1``) nor adds to it (``dt·B·xᵀ = 0``), and no real row
    reads it (the intra-chunk term is causal), so the final state is the
    state after the last real row; the padded rows' outputs are dropped.
    A multiple of ``chunk`` runs as before, bit for bit.
    """
    s = x.shape[1]
    pad = -s % min(chunk, s)
    if pad:
        x, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, state = _ssd(x, dt, A, B, C, D, min(chunk, s), init_state)
    return (y[:, :s] if pad else y), state


def _ssd(x, dt, A, B, C, D, chunk: int, init_state):
    """:func:`ssd_chunked` of a sequence that is a multiple of ``chunk``."""
    acc = wide(x.dtype)
    b, s, h, p = x.shape
    n = B.shape[-1]
    c = s // chunk
    xf = reshape(x.to(acc), b, c, chunk, h, p)
    dtf = reshape(dt.to(acc), b, c, chunk, h)
    Bf = reshape(B.to(acc), b, c, chunk, n)
    Cf = reshape(C.to(acc), b, c, chunk, n)
    dA = dtf * A  # (b,c,l,h)

    # intra-chunk (quadratic within chunk)
    Ldec = torch.exp(_segsum(dA.movedim(-1, -2)))             # (b,c,h,l,l)
    scores = einsum("bcin,bcjn->bcij", Cf, Bf)          # (b,c,l,l)
    att = scores[:, :, None] * Ldec                           # (b,c,h,l,l)
    y_intra = einsum("bchij,bcjh,bcjhp->bcihp", att, dtf, xf)

    # chunk-final states
    dA_cum = cumsum(dA, dim=2)                          # (b,c,l,h)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (b,c,l,h)
    states = einsum("bcln,bclh,bclhp->bchpn",
                          Bf, dtf * decay_to_end, xf)         # (b,c,h,p,n)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (b,c,h)

    # inter-chunk recurrence (the reference's lax.scan), emitting the
    # state before each chunk
    carry = (init_state if init_state is not None
             else torch.zeros((b, h, p, n), dtype=acc, device=x.device))
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                    # (b,c,h,p,n)

    # inter-chunk contribution
    in_decay = torch.exp(dA_cum)                              # (b,c,l,h)
    y_inter = einsum("bcln,bclh,bchpn->bclhp", Cf, in_decay,
                           prev_states)

    y = y_intra + y_inter + D[None, None, :, None] * xf
    return reshape(y, b, s, h, p).to(x.dtype), carry


def ssd_step(x, dt, A, B, C, D, state):
    """Single-token recurrence. x (b,h,p); dt (b,h); B,C (b,n);
    state (b,h,p,n)."""
    acc = wide(x.dtype)
    xf, dtf = x.to(acc), dt.to(acc)
    dA = torch.exp(dtf * A)                                   # (b,h)
    new_state = state * dA[..., None, None] + einsum(
        "bh,bn,bhp->bhpn", dtf, B.to(acc), xf)
    y = einsum("bn,bhpn->bhp", C.to(acc), new_state) \
        + D[None, :, None] * xf
    return y.to(x.dtype), new_state


def _gate(p, cfg: ModelConfig, y, z):
    """The SSD's output ``y`` gated by ``silu(z)``, in ``y``'s dtype; under
    ``ssm_gated_norm``, Mamba-2's gated RMSNorm ``rmsnorm(y·silu(z))·w``
    over ``d_inner`` (one group), computed in float32 with ε
    ``norm_eps``."""
    acc = wide(y.dtype)
    if not cfg.ssm_gated_norm:
        return y * F.silu(z.to(acc)).to(y.dtype)
    g = y.to(acc) * F.silu(z.to(acc))
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return (g * p["norm"].to(acc)).to(y.dtype)


def apply_mamba(p, cfg: ModelConfig, x, *, chunk: Optional[int] = None):
    """Full-sequence mamba2 block. x (B,S,D) -> (B,S,D), and the final
    states ``{"ssm": (B,H,P,N), "conv": the last K-1 pre-conv inputs}``,
    so a prefill can seed decoding (zeros before a prompt shorter than
    K-1). ``chunk`` is the SSD's, :data:`CHUNK` by default."""
    acc = wide(x.dtype)
    B_, S, D = x.shape
    DI, H, Pd, N = cfg.di, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    zxbcdt = _proj("bsd,de->bse", x, p["in_proj"])
    zxbcdt = constrain(zxbcdt, ("batch", None, "d_inner"))
    z, xs, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([xs, Bc, Cc], dim=-1)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs, Bc, Cc = torch.split(xbc, [DI, N, N], dim=-1)
    dtv = F.softplus(dt.to(acc) + p["dt_bias"])               # (B,S,H)
    A = -torch.exp(p["A_log"])                                # (H,)
    y, state = ssd_chunked(reshape(xs, B_, S, H, Pd), dtv, A, Bc, Cc,
                           p["D"], chunk=chunk or CHUNK)
    y = _gate(p, cfg, reshape(y, B_, S, DI), z)
    out = _proj("bse,ed->bsd", y, p["out_proj"])
    K = cfg.conv_dim
    if S < K - 1:
        xbc_raw = F.pad(xbc_raw, (0, 0, K - 1 - S, 0))
    conv_tail = xbc_raw[:, -(K - 1):, :]
    return constrain(out, ("batch", None, None)), {"ssm": state,
                                                   "conv": conv_tail}


def apply_mamba_step(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """One-token decode. x (B,1,D); conv_state (B,K-1,conv_ch);
    ssm_state (B,H,P,N). Returns y (B,1,D) and updated states."""
    acc = wide(x.dtype)
    B_, _, D = x.shape
    DI, H, Pd, N = cfg.di, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    zxbcdt = _proj("bsd,de->bse", x, p["in_proj"])[:, 0]       # (B, E)
    z, xs, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)                     # (B, conv_ch)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (B,K,ch)
    conv_out = einsum("bkc,kc->bc", window.to(acc),
                            p["conv_w"].to(acc)) + p["conv_b"].to(acc)
    xbc = F.silu(conv_out).to(x.dtype)
    xs, Bc, Cc = torch.split(xbc, [DI, N, N], dim=-1)
    dtv = F.softplus(dt.to(acc) + p["dt_bias"])               # (B,H)
    A = -torch.exp(p["A_log"])
    y, new_ssm = ssd_step(reshape(xs, B_, H, Pd), dtv, A, Bc, Cc, p["D"],
                          ssm_state)
    y = _gate(p, cfg, reshape(y, B_, DI), z)
    out = _proj("be,ed->bd", y, p["out_proj"])[:, None, :]
    return out, window[:, 1:, :], new_ssm


__all__ = ["CHUNK", "apply_mamba", "apply_mamba_step", "mamba_specs",
           "ssd_chunked", "ssd_plain", "ssd_step", "tail_rows"]
