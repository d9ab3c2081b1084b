"""Kernels executor backend: lower eligible compiled traces onto the port's
hand-written kernels.

The counterpart of ``src/repro/core/pallas_exec.py`` (renamed: the port's
kernels are CUDA, not Pallas). ``execute(cp, mem, backend="kernels")`` runs the
*algorithm* a trace encodes — not its cycle-by-cycle gate replay — on
:mod:`repro_torch.kernels`:

=================  =============================  ==========================
trace kind         kernel                         eligibility
=================  =============================  ==========================
binary matvec      ``binary_matmul``              always (int32 popcount
(±1 XNOR-popcount)  (XNOR + popcount reduction)    reduction is exact)
encoded matvec     ``splitk_matvec``              ``n·(2^N−1)² < 2^24``
(N-bit, mod 2^2N)   (f32 accumulate)               (f32-exact integer range)
valid conv         ``conv2d_shift``               ``k²·(2^N−1)² < 2^24``;
(N-bit, mod 2^N)    (shifted multiply-adds)        K known or stored in-array
=================  =============================  ==========================

Algorithm plans attach a ``kernel_spec`` (layout manifest) to the traces
they compile. The backend extracts operand bits from the INITIAL memory
images on the device, decodes or packs them there, launches ONE kernel for
every instance of the batch (the reference loops instances), and writes only
the plan's result field into otherwise-zero images. Cycle and stat
accounting still come from the compiled trace.

Result contract: the plan's decode functions (``decode_y``,
``decode_popcount``, ``decode_out``) read bit-identical values off a kernels
run and a replay. The arithmetic bridges:

* binary matvec pads n to whole words with zero bits in BOTH operands (pad
  positions XNOR-match, so the mismatch count is untouched);
  ``mism = (kpad − dot)/2``, ``pop = n − mism``, and the stored field is
  ``(pop − n//2) mod 2^W`` — the two's-complement threshold form Phase 5 of
  the plan program produces. The port pads only to whole words
  (``kpad = 32·ceil(n/32)``), not to the TPU kernel's block multiple.
* encoded matvec and conv: f32 accumulation of integers is exact while the
  true sum stays below 2^24 (the mantissa width); eligibility enforces the
  bound, and the result is rounded (``torch.round``) and reduced mod 2^W
  (matvec) or 2^N (conv) with ``torch.remainder``, which like numpy's ``%``
  is non-negative for the negative taps a K-specialized program may carry.
  The port does not pad to the TPU kernel's 256/512 blocks.

Ineligible traces (no spec, faults requested, or the bound exceeded) replay
on ``torch`` with the label ``"kernels:fallback-torch"``. A kernel that
fails to build or launch raises; it is never a fallback.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .engine import as_int32_words

# f32 mantissa: sums of integers below this in magnitude are exact
_F32_EXACT = 1 << 24


def binary_matvec_spec(plan) -> dict:
    """Layout manifest for :class:`repro_torch.core.binary_matvec.
    BinaryMatvecPlan`."""
    P, cp, npp = plan.P, plan.cp, plan.npp
    return {
        "kind": "binary_matvec",
        "m": plan.m, "n": plan.n, "W": plan._W,
        # p-major: column j of A lives at a_cols[j] (load_into order)
        "a_cols": np.array([p * cp + plan.a_off[j]
                            for p in range(P) for j in range(npp)]),
        "x_cols": np.array([p * cp + plan.x_off[j]
                            for p in range(P) for j in range(npp)]),
        "total_cols": np.array(plan._total_field),
        "y_col": plan.y_off,
    }


def matvec_spec(plan) -> dict:
    """Layout manifest for :class:`repro_torch.core.matvec.MatvecPlan`."""
    return {
        "kind": "matvec",
        "m": plan.m, "n": plan.n, "N": plan.N, "W": plan.W,
        "alpha": plan.alpha, "nb": plan.nb,
        "a_cols": np.array(plan.a_fields).reshape(-1),   # [j][b] order
        "x_cols": np.array(plan.x_fields).reshape(-1),
        "acc_cols": np.array(plan.acc),
    }


def conv_spec(plan) -> Optional[dict]:
    """Layout manifest for :class:`repro_torch.core.conv.ConvPlan`.

    K-specialized / kernel-streaming programs bake K into the trace — the
    spec captures the bound kernel (raw, so it may hold negative taps).
    Returns ``None`` (ineligible) if such a program was built without
    binding K (the dummy-K ``cycles`` probe).
    """
    k_in_program = plan.specialize or plan.stream_kernel
    if k_in_program and plan.K is None:
        return None
    return {
        "kind": "conv",
        "m": plan.m, "n": plan.n, "k": plan.k, "N": plan.N,
        "alpha": plan.alpha, "nb": plan.nb, "nin": plan.nin,
        "mpad": plan.mpad, "m_out": plan.m_out, "n_out": plan.n_out,
        "a_cols": np.array(plan.a_fields).reshape(-1),   # [e][b] order
        "out_fields": [np.array(f) for f in plan.out_fields],
        "kstore": np.array(plan.kstore, dtype=np.int64),
        "K": plan.K.copy() if k_in_program else None,
    }


def kernels_eligible(cp, faults=None) -> bool:
    """Can ``cp`` run on the kernels backend bit-identically?"""
    spec = getattr(cp, "kernel_spec", None)
    if spec is None or faults is not None:
        return False
    kind = spec["kind"]
    if kind == "binary_matvec":
        return True          # int32 popcount reduction is always exact
    peak = (1 << spec["N"]) - 1
    if kind == "matvec":
        return spec["n"] * peak * peak < _F32_EXACT
    if kind == "conv":
        return spec["k"] ** 2 * peak * peak < _F32_EXACT
    return False


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(…, n) {0,1} → (…, ceil(n/32)) int32 words, little-endian bit order
    (bit ``b`` of word ``w`` = element ``32w + b``), zero-padded."""
    n = bits.shape[-1]
    words = -(-n // 32)
    pad = words * 32 - n
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = bits.reshape(bits.shape[:-1] + (words, 32)).to(torch.int64) << shifts
    return as_int32_words(w.sum(-1))


def _bits_of(values: torch.Tensor, nbits: int) -> torch.Tensor:
    """int64 values → (…, nbits) uint8 bits, LSB first (``encode_uint``)."""
    shifts = torch.arange(nbits, dtype=torch.int64, device=values.device)
    return ((values[..., None] >> shifts) & 1).to(torch.uint8)


def _run_binary_matvec(spec, mems: torch.Tensor) -> torch.Tensor:
    from ..kernels.binary_matmul import binary_matmul

    dev = mems.device
    m, n, W = spec["m"], spec["n"], spec["W"]
    a_cols = torch.from_numpy(spec["a_cols"]).to(dev)
    x_cols = torch.from_numpy(spec["x_cols"]).to(dev)
    total_cols = torch.from_numpy(spec["total_cols"]).to(dev)
    a_packed = _pack_words(mems[:, :m][:, :, a_cols])       # (B, m, Kw)
    x_packed = _pack_words(mems[:, 0][:, x_cols])[:, None]  # (B, 1, Kw)
    kpad = a_packed.shape[-1] * 32
    dot = binary_matmul(a_packed, x_packed)[:, :, 0].to(torch.int64)
    mism = (kpad - dot) // 2                                # pad bits match
    total = (n - mism - n // 2) % (1 << W)                  # pop − n/2 mod 2^W
    out = torch.zeros_like(mems)
    out[:, :m, total_cols] = _bits_of(total, len(total_cols))
    out[:, :m, spec["y_col"]] = (1 - ((total >> (W - 1)) & 1)).to(
        torch.uint8)
    return out


def _decode_fields(mems: torch.Tensor, rows: slice, cols: torch.Tensor,
                   N: int) -> torch.Tensor:
    """(B, |rows|, len(cols)) bit block → (B, |rows|, len(cols)//N) int64,
    each N-bit field decoded LSB first with int64 shifts on the device."""
    bits = mems[:, rows][:, :, cols].to(torch.int64)
    B, R = bits.shape[:2]
    shifts = torch.arange(N, dtype=torch.int64, device=mems.device)
    return (bits.reshape(B, R, -1, N) << shifts).sum(-1)


def _run_matvec(spec, mems: torch.Tensor) -> torch.Tensor:
    from ..kernels.splitk_matvec import splitk_matvec

    dev = mems.device
    m, n, N, W = spec["m"], spec["n"], spec["N"], spec["W"]
    alpha, nb = spec["alpha"], spec["nb"]
    a_cols = torch.from_numpy(spec["a_cols"]).to(dev)
    x_cols = torch.from_numpy(spec["x_cols"]).to(dev)
    B = mems.shape[0]
    A = torch.empty((B, m, n), dtype=torch.int64, device=dev)
    x = torch.empty((B, n), dtype=torch.int64, device=dev)
    for i in range(alpha):       # band i holds block i of A and x
        A[:, :, i * nb:(i + 1) * nb] = _decode_fields(
            mems, slice(i * m, (i + 1) * m), a_cols, N)
        x[:, i * nb:(i + 1) * nb] = _decode_fields(
            mems, slice(i * m, i * m + 1), x_cols, N)[:, 0]
    y = splitk_matvec(A.to(torch.float32), x.to(torch.float32))  # (B, m)
    y = torch.remainder(torch.round(y).to(torch.int64), 1 << W)  # exact
    out = torch.zeros_like(mems)
    out[:, :m, torch.from_numpy(spec["acc_cols"]).to(dev)] = _bits_of(y, W)
    return out


def _run_conv(spec, mems: torch.Tensor) -> torch.Tensor:
    from ..kernels.conv2d_shift import conv2d_shift

    dev = mems.device
    m, n, k, N = spec["m"], spec["n"], spec["k"], spec["N"]
    alpha, nb, nin, mpad = (spec["alpha"], spec["nb"], spec["nin"],
                            spec["mpad"])
    m_out, n_out = spec["m_out"], spec["n_out"]
    B = mems.shape[0]

    a_cols = torch.from_numpy(spec["a_cols"]).to(dev)
    A = torch.zeros((B, m, n), dtype=torch.int64, device=dev)
    for i in range(alpha):       # band i holds column block i (with halo)
        lo, c0 = i * mpad, i * nb
        valid = min(nin, n - c0)
        if valid > 0:            # halo overlaps agree
            A[:, :, c0:c0 + valid] = _decode_fields(
                mems, slice(lo, lo + m), a_cols, N)[:, :, :valid]

    if spec["K"] is not None:
        # K baked into the program: one kernel for every instance
        Ks = torch.as_tensor(spec["K"], dtype=torch.int64, device=dev)
    else:
        # K bits live in-array (kstore, band-replicated): bit β of the flat
        # LSB-first kernel stream sits at (row β % m, col kstore[β // m]) —
        # read band 0 per instance (serving batches distinct kernels)
        beta = torch.arange(k * k * N, device=dev)
        kstore = torch.from_numpy(spec["kstore"]).to(dev)
        kb = mems[:, beta % m, kstore[beta // m]].to(torch.int64)
        shifts = torch.arange(N, dtype=torch.int64, device=dev)
        Ks = (kb.reshape(B, k * k, N) << shifts).sum(-1).reshape(B, k, k)
    o = conv2d_shift(A.to(torch.float32),
                     Ks.to(torch.float32).contiguous())   # (B, m_out, n_out)
    o = torch.remainder(torch.round(o).to(torch.int64), 1 << N)  # exact

    # output column i·nb + c of the map lives in band i, field c
    pairs = [(i, c) for i in range(alpha) for c in range(nb)
             if i * nb + c < n_out]
    lo = torch.tensor([i * mpad for i, _ in pairs], device=dev)
    src = torch.tensor([i * nb + c for i, c in pairs], device=dev)
    fcols = torch.from_numpy(np.stack(
        [spec["out_fields"][c] for _, c in pairs])).to(dev)    # (P, N)
    rows = (torch.arange(m_out, device=dev)[:, None, None]
            + lo[None, :, None])                                # (m_out, P, 1)
    out = torch.zeros_like(mems)
    out[:, rows, fcols[None]] = _bits_of(o[:, :, src], N)      # (B, m_out, P, N)
    return out


_RUNNERS = {
    "binary_matvec": _run_binary_matvec,
    "matvec": _run_matvec,
    "conv": _run_conv,
}


def run_kernels(cp, mems: torch.Tensor) -> torch.Tensor:
    """Run an eligible trace's algorithm on the kernels.

    ``mems`` is ``(B, rows, cols)`` uint8 initial state on a device; returns
    the final images per the result contract above. The caller
    (``engine.execute``) checks :func:`kernels_eligible` first.
    """
    spec = cp.kernel_spec
    return _RUNNERS[spec["kind"]](spec, mems)


__all__ = ["binary_matvec_spec", "conv_spec", "kernels_eligible",
           "matvec_spec", "run_kernels"]
