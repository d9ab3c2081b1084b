"""XNOR-popcount GEMM — MatPIM §II-B on the GPU.

The port of ``src/repro/kernels/binary_matmul.py``. ±1 operands are
bit-packed, 32 per word (bit 1 = +1), and

    C[i, j] = Σ_k a[i, k]·b[j, k]  =  K − 2·popcount(a_bits ^ b_bits),

with ``K = 32·Kw``. :func:`binary_matmul` launches the hand-written CUDA
kernel in ``csrc/binary_matmul.cu`` for tensors on a CUDA device and takes
:func:`binary_matmul_plain`, the same function in plain PyTorch, for tensors
on the CPU. There is no fallback from one to the other.

Words are ``torch.int32`` holding the reference's uint32 bits: torch has no
shifts for ``uint32`` on the CPU. Both versions take an optional leading
batch axis, A ``(B, M, Kw)`` and B ``(B, N, Kw)`` giving ``(B, M, N)``; each
batch entry is the TPU kernel's function, and the CUDA kernel serves the
whole batch in one launch.

What bounds it. The main path calls it with N = 1: 20 tiles of 1024 rows
of Kw = 13 words (52-byte rows), about 1.1 MB, so the launch and the host
path around it are most of its time. :func:`binary_launch_plan` picks one
of two kernels. N = 1: a CTA stages a run of whole rows of A, one
contiguous span, into shared memory with 16-byte copies, and one thread (or
a small group of lanes) per row XORs and counts it against x's words, so no
lane idles on a 13-word row. N > 1 (``ops.binary_dense``), or rows too long
to stage: a CTA holds a tile of A's rows and 32 of B's rows in shared
memory, a chunk of 32 words at a time (rows of at most 8 words are read
directly), and each thread counts one B row against several A rows. The host path is the shared one of
``kernels.launch``: checks and packed arguments cached per signature.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import MIN_CTAS, Signature, launch, span_bytes, staged_rows

SOURCE = "binary_matmul.cu"
SYMBOL = "matpim_binary_matmul"

# The tile kernel's shape (``kTile*`` in the CUDA source).
TILE_N = 32          # B rows per CTA, one per lane
TILE_WARPS = 8       # a CTA's warps; each thread counts MAX_RM A rows ...
MAX_RM = 4           # ... or fewer, down to 1, to fill the SMs
K_CHUNK = 32         # words of a row staged at once
DIRECT_WORDS = 8     # rows of at most this many words are read directly

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


class BinaryLaunch(NamedTuple):
    """One launch of the binary kernel. ``rows_mode`` (N = 1): ``rows``
    consecutive rows of A per CTA staged as one span, ``lanes`` threads per
    row, x's words at ``x_off``. Otherwise ``rm`` A rows per thread, CTA
    tiles of ``TILE_WARPS·rm`` A rows by ``TILE_N`` B rows, ``tiles_n`` of
    them across N, ``staged`` through shared memory or read directly."""
    rows_mode: bool
    rows: int
    threads: int
    lanes: int
    rot: int
    rm: int
    tiles_n: int
    staged: bool
    grid: tuple[int, int]     # (CTAs per batch entry, batch entries)
    smem: int
    x_off: int


@functools.lru_cache(maxsize=1024)
def binary_launch_plan(B: int, M: int, N: int, Kw: int) -> BinaryLaunch:
    """The kernel and CTA shape of one launch over ``B`` batch entries of
    A ``(M, Kw)`` against B ``(N, Kw)``.

    N = 1 takes the row kernel, planned by ``kernels.staged_rows`` (rows
    per CTA a power of two up to 128, at least ``min(132, B·M)`` CTAs,
    shared memory within 48 KB), unless one row and x do not fit 48 KB.
    Otherwise the tile kernel: ``rm`` from ``MAX_RM`` halved while there
    are fewer than 132 CTAs, staged with shared memory for ``(TILE_WARPS·rm
    + TILE_N)`` rows of ``K_CHUNK + 1`` words, or for rows of at most
    ``DIRECT_WORDS`` words read directly."""
    if N == 1:
        p = staged_rows(B, M, Kw, 4, span_bytes(1, Kw, 4))
        if p is not None:
            return BinaryLaunch(rows_mode=True, rows=p.rows,
                                threads=p.threads, lanes=p.lanes, rot=p.rot,
                                rm=0, tiles_n=1, staged=True, grid=p.grid,
                                smem=p.smem, x_off=p.x_off)
    tiles_n = -(-N // TILE_N)

    def ctas(rm):
        return -(-M // (TILE_WARPS * rm)) * tiles_n * B

    rm = MAX_RM
    while rm > 1 and ctas(rm) < MIN_CTAS:
        rm //= 2
    staged = Kw > DIRECT_WORDS
    return BinaryLaunch(rows_mode=False, rows=TILE_WARPS * rm,
                        threads=32 * TILE_WARPS, lanes=1, rot=0, rm=rm,
                        tiles_n=tiles_n, staged=staged,
                        grid=(ctas(rm) // B, B),
                        smem=4 * (TILE_WARPS * rm + TILE_N) * (K_CHUNK + 1)
                        if staged else 0, x_off=0)


class _Args(ctypes.Structure):
    """The kernel's launch arguments (``BinaryArgs`` in the CUDA source,
    same field order), packed once per signature and passed by address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "M", "N", "Kw", "rows_mode", "rows", "threads", "lanes", "rot",
        "rm", "tiles_n", "staged", "smem", "x_off", "grid_x")]


@functools.lru_cache(maxsize=256)
def _signature(a_shape, b_shape, a_dtype, b_dtype) -> Signature:
    """The checks, output shape, refusal and packed launch arguments of one
    shape and dtype signature (a raise is not cached)."""
    if a_dtype != torch.int32 or b_dtype != torch.int32:
        raise TypeError(f"binary_matmul takes int32 words, got {a_dtype} "
                        f"and {b_dtype}")
    if len(a_shape) not in (2, 3) or len(a_shape) != len(b_shape):
        raise ValueError(f"binary_matmul takes (M, Kw) and (N, Kw), or "
                         f"batched (B, M, Kw) and (B, N, Kw); got "
                         f"{tuple(a_shape)} and {tuple(b_shape)}")
    if a_shape[-1] != b_shape[-1] or a_shape[:-2] != b_shape[:-2]:
        raise ValueError(f"operand shapes {tuple(a_shape)} and "
                         f"{tuple(b_shape)} disagree on batch or Kw")
    nb = a_shape[0] if len(a_shape) == 3 else 1
    (M, Kw), N = a_shape[-2:], b_shape[-2]
    out_shape = tuple(a_shape[:-1]) + (N,)
    if max(M * Kw, N * Kw, M * N) >= 1 << 31 or nb > 65535:
        return Signature(out_shape, torch.int32, 0,
                         f"binary_matmul shape {(nb, M, N, Kw)} exceeds "
                         f"the kernel's index range", None, 0)
    if nb * M * N == 0:
        return Signature(out_shape, torch.int32, 0, None, None, 0)
    p = binary_launch_plan(nb, M, N, Kw)
    args = _Args(nb, M, N, Kw, int(p.rows_mode), p.rows, p.threads, p.lanes,
                 p.rot, p.rm, p.tiles_n, int(p.staged), p.smem, p.x_off,
                 p.grid[0])
    return Signature(out_shape, torch.int32, nb * M * N, None, args,
                     ctypes.addressof(args))


def binary_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A ±1-dot B for packed words: A (M, Kw), B (N, Kw) int32 →
    (M, N) int32, or batched (B, M, Kw), (B, N, Kw) → (B, M, N).

    CUDA tensors go to the kernel (one launch; ``binary_matmul.launches``
    counts launches), CPU tensors to :func:`binary_matmul_plain`.
    """
    sig = _signature(a.shape, b.shape, a.dtype, b.dtype)
    c = launch(binary_matmul, sig, a, b, SOURCE, SYMBOL)
    return binary_matmul_plain(a, b) if c is None else c


binary_matmul.launches = 0
