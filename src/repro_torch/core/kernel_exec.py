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
=================  =============================  ==========================

The encoded matvec and conv bridges (``splitk_matvec``, ``conv2d_shift``)
arrive with their kernels (ROADMAP Queue 2).

Algorithm plans attach a ``kernel_spec`` (layout manifest) to the traces
they compile. The backend extracts operand bits from the INITIAL memory
images on the device, packs them, launches ONE kernel for every instance of
the batch (the reference loops instances), and writes only the plan's
result field into otherwise-zero images. Cycle and stat accounting still
come from the compiled trace.

Result contract: the plan's ``decode_y`` and ``decode_popcount`` read
bit-identical values off a kernels run and a replay. Binary matvec pads n
to whole words with zero bits in BOTH operands (pad positions XNOR-match, so
the mismatch count is untouched); ``mism = (kpad − dot)/2``,
``pop = n − mism``, and the stored field is ``(pop − n//2) mod 2^W`` — the
two's-complement threshold form Phase 5 of the plan program produces. The
port pads only to whole words (``kpad = 32·ceil(n/32)``), not to the TPU
kernel's block multiple.

Ineligible traces (no spec, or faults requested) replay on ``torch`` with
the label ``"kernels:fallback-torch"``. A kernel that fails to build or
launch raises; it is never a fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import as_int32_words


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


def kernels_eligible(cp, faults=None) -> bool:
    """Can ``cp`` run on the kernels backend bit-identically?"""
    spec = getattr(cp, "kernel_spec", None)
    return (spec is not None and faults is None
            and spec["kind"] == "binary_matvec")


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
    shifts = torch.arange(len(total_cols), dtype=torch.int64, device=dev)
    out[:, :m, total_cols] = ((total[..., None] >> shifts) & 1).to(
        torch.uint8)
    out[:, :m, spec["y_col"]] = (1 - ((total >> (W - 1)) & 1)).to(
        torch.uint8)
    return out


_RUNNERS = {"binary_matvec": _run_binary_matvec}


def run_kernels(cp, mems: torch.Tensor) -> torch.Tensor:
    """Run an eligible trace's algorithm on the kernels.

    ``mems`` is ``(B, rows, cols)`` uint8 initial state on a device; returns
    the final images per the result contract above. The caller
    (``engine.execute``) checks :func:`kernels_eligible` first.
    """
    spec = cp.kernel_spec
    return _RUNNERS[spec["kind"]](spec, mems)


__all__ = ["binary_matvec_spec", "kernels_eligible", "run_kernels"]
