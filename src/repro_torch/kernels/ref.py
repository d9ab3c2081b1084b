"""Plain PyTorch oracles for the port's kernels (the port of
``src/repro/kernels/ref.py``), and the crossbar-engine oracles that take
the simulated stateful-logic hardware itself as the ±1 kernel's ground
truth. Words are int32 holding the reference's uint32 bits.
"""
from __future__ import annotations

import numpy as np
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


def splitk_matvec_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with f32 accumulation (A may be bf16)."""
    return torch.matmul(a.to(torch.float32), x.to(torch.float32))


def conv2d_shift_ref(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid 2D convolution (no flip — cross-correlation, as MatPIM Alg. 1).

    a: (H, W), k: (kh, kw). f32 accumulation.
    """
    H, W = a.shape
    kh, kw = k.shape
    out = torch.zeros((H - kh + 1, W - kw + 1), dtype=torch.float32,
                      device=a.device)
    for v in range(kh):
        for h in range(kw):
            out = out + a[v:H - kh + 1 + v, h:W - kw + 1 + h].to(
                torch.float32) * k[v, h].to(torch.float32)
    return out


def crossbar_binary_matvec_ref(a, x, device="cuda",
                               backend: str = "torch") -> np.ndarray:
    """±1 matvec dot values from the compiled MatPIM crossbar engine.

    The (tiled, batched) stateful-logic program computes per-row XNOR
    popcounts on ``device`` with the engine's ``backend``, and
    ⟨a, x⟩ = 2·popcount − K. Accepts any (M, K); rows and columns beyond
    one 1024×1024 array are handled by the tiling layer. Returns int64.
    """
    from ..core.tiling import TiledBinaryMatvec

    a = np.asarray(a, dtype=np.int64)
    x = np.asarray(x, dtype=np.int64)
    M, K = a.shape
    pop = TiledBinaryMatvec(M, K).popcounts(a, x, backend=backend,
                                            device=device)
    return 2 * pop - K


def crossbar_binary_matmul_ref(a, b, device="cuda",
                               backend: str = "torch") -> np.ndarray:
    """±1 GEMM dot values via the compiled crossbar engine: every (row of
    ``b``, crossbar tile) pair runs in one bit-plane-packed engine batch.
    ``a`` is (M, K), ``b`` (N, K); returns (M, N) int64 dots."""
    from ..core.tiling import TiledBinaryMatvec

    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    M, K = a.shape
    pops = TiledBinaryMatvec(M, K).popcounts_many(a, b, backend=backend,
                                                  device=device)
    return (2 * pops - K).T


def binary_conv2d_ref(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Channel-packed binary conv: a (H, W, C/32) int32 words, k (kh, kw,
    C/32) int32 words, output int32 ±1 dot over (kh, kw, C)."""
    H, W, Cw = a.shape
    kh, kw, _ = k.shape
    C = Cw * 32
    out = torch.zeros((H - kh + 1, W - kw + 1), dtype=torch.int64,
                      device=a.device)
    for v in range(kh):
        for h in range(kw):
            x = a[v:H - kh + 1 + v, h:W - kw + 1 + h, :] ^ k[v, h, :]
            out = out + (C - 2 * popcount32(x).sum(-1))
    return out.to(torch.int32)
