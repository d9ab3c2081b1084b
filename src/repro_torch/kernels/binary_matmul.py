"""XNOR-popcount GEMM — MatPIM §II-B on the GPU.

The port of ``src/repro/kernels/binary_matmul.py``. ±1 operands are
bit-packed, 32 per word (bit 1 = +1), and

    C[i, j] = Σ_k a[i, k]·b[j, k]  =  K − 2·popcount(a_bits ^ b_bits),

with ``K = 32·Kw``. :func:`binary_matmul` launches the hand-written CUDA
kernel in ``csrc/binary_matmul.cu`` for tensors on a CUDA device (the note
there says what bounds it and how the TPU kernel's sequential k-grid maps to
Hopper) and takes :func:`binary_matmul_plain`, the same function in plain
PyTorch, for tensors on the CPU. There is no fallback from one to the other.

Words are ``torch.int32`` holding the reference's uint32 bits: torch has no
shifts for ``uint32`` on the CPU. Both versions take an optional leading
batch axis, A ``(B, M, Kw)`` and B ``(B, N, Kw)`` giving ``(B, M, N)``; each
batch entry is the TPU kernel's function, and the CUDA kernel serves the
whole batch in one launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import load_library

SOURCE = "binary_matmul.cu"

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (masked SWAR in int64)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def binary_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: A (…, M, Kw), B (…, N, Kw) int32 → (…, M, N)
    int32 ±1 dot products."""
    mism = popcount32(a[..., :, None, :] ^ b[..., None, :, :]).sum(-1)
    return (32 * a.shape[-1] - 2 * mism).to(torch.int32)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"binary_matmul takes int32 words, got {a.dtype} "
                        f"and {b.dtype}")
    if a.ndim not in (2, 3) or a.ndim != b.ndim:
        raise ValueError(f"binary_matmul takes (M, Kw) and (N, Kw), or "
                         f"batched (B, M, Kw) and (B, N, Kw); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-1] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"operand shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} disagree on batch or Kw")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def binary_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A ±1-dot B for packed words: A (M, Kw), B (N, Kw) int32 →
    (M, N) int32, or batched (B, M, Kw), (B, N, Kw) → (B, M, N).

    CUDA tensors go to the kernel (one launch; ``binary_matmul.launches``
    counts launches), CPU tensors to :func:`binary_matmul_plain`.
    """
    _check(a, b)
    if a.device.type == "cpu":
        return binary_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"binary_matmul runs on CUDA or the CPU, not "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("binary_matmul takes contiguous operands")
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):    # launch on the operands' card
            return binary_matmul(a, b)
    batched = a.ndim == 3
    a3 = a if batched else a[None]
    b3 = b if batched else b[None]
    nb, M, Kw = a3.shape
    N = b3.shape[1]
    if max(M * Kw, N * Kw, M * N) >= 1 << 31 or nb > 65535:
        raise ValueError(f"binary_matmul shape {(nb, M, N, Kw)} exceeds "
                         f"the kernel's index range")
    c = torch.empty((nb, M, N), dtype=torch.int32, device=a.device)
    if c.numel():
        err = _entry()(a3.data_ptr(), b3.data_ptr(), c.data_ptr(), nb, M,
                       N, Kw, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"binary_matmul launch failed: CUDA error "
                               f"{err}")
        binary_matmul.launches += 1
    return c if batched else c[0]


binary_matmul.launches = 0


@functools.cache
def _entry():
    """The C entry point, built and loaded at first use, with its ctypes
    signature (pointers and the stream as ``c_void_p``)."""
    fn = load_library(SOURCE).matpim_binary_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
