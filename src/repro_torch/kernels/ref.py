"""Plain PyTorch oracles for the port's kernels (the binary parts of
``src/repro/kernels/ref.py``). Words are int32 holding the reference's
uint32 bits.
"""
from __future__ import annotations

import torch

from .binary_matmul import popcount32


def pack_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a ±1 (or {0,1}) tensor into int32 words along ``axis``.

    +1 → bit 1, −1/0 → bit 0, bit ``b`` of word ``w`` = element ``32w + b``.
    Axis length must be a multiple of 32.
    """
    bits = torch.movedim((x > 0).to(torch.int64), axis, -1)
    *lead, n = bits.shape
    if n % 32:
        raise ValueError("pack axis must be a multiple of 32")
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    packed = (bits.reshape(*lead, n // 32, 32) << shifts).sum(-1)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
    return torch.movedim(packed.to(torch.int32), -1, axis)


def binary_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """±1 GEMM: C[i,j] = Σ_k a[i,k]·b[j,k] with a,b ∈ {−1,+1}.

    a: (M, K) ±1, b: (N, K) ±1 (b stored K-major like the packed kernel
    input). Returns int32 (M, N).
    """
    prod = a.to(torch.int64)[:, None, :] * b.to(torch.int64)[None, :, :]
    return prod.sum(-1).to(torch.int32)


def binary_matmul_packed_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                             K: int) -> torch.Tensor:
    """Same contract as the kernel: packed int32 inputs, ±1 dot output."""
    x = a_packed[:, None, :] ^ b_packed[None, :, :]
    match = K - popcount32(x).sum(-1)
    return (2 * match - K).to(torch.int32)    # ⟨a,b⟩ = matches − mismatches
