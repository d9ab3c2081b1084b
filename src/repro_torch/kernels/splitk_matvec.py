"""Split-K matrix-vector product — MatPIM §II-A on the GPU.

The port of ``src/repro/kernels/splitk_matvec.py``. MatPIM splits the
contraction axis into α blocks computed in parallel row bands and
tree-reduces the partial vectors; the TPU kernel runs the same split as a
sequential k-grid. :func:`splitk_matvec` computes ``y = A @ x`` with float32
accumulation (A and x each float32 or bfloat16): CUDA tensors go to the
hand-written kernel in ``csrc/splitk_matvec.cu``, CPU tensors to
:func:`splitk_matvec_plain`, the same function in plain PyTorch. There is
no fallback from one to the other.

Both versions take an optional leading batch axis, A ``(B, M, K)`` and x
``(B, K)`` giving ``(B, M)``; each batch entry is the TPU kernel's function,
and the CUDA kernel serves the whole batch in one launch.

What bounds it. The served path calls it on 27 tiles of 1024 rows of
K = 39 floats (156-byte rows): 4.3 MB read, the launch and the host path
around it are most of its time. :func:`matvec_launch_plan` picks one of two
modes of the kernel. Short rows (at most ``SHORT_ROW_BYTES``): a CTA stages
a run of whole rows, one contiguous span, into shared memory with 16-byte
copies, and one thread (or a small group of lanes) reduces each row, so no
lane idles on a row too short for a warp. Long rows: a warp (or several,
splitting K) per row reads it with 16-byte loads against x staged once per
CTA. The host path is the
shared one of ``kernels.launch``: checks and packed arguments cached per
signature.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import MIN_CTAS, Signature, launch, span_bytes, staged_rows

SOURCE = "splitk_matvec.cu"
SYMBOL = "matpim_splitk_matvec"
DTYPES = (torch.float32, torch.bfloat16)

# The launch plan's constants, for the H100 SXM.
SHORT_ROW_BYTES = 512   # rows up to this long are staged whole
MAX_WARPS = 8           # warps of a long-row CTA
MIN_ROWS = 4            # rows a long-row CTA keeps to share its staged x
PREFETCH = 4            # 16-byte chunks of A a thread loads before x lands
X_CHUNK = 8192          # x elements a long-row CTA stages at once (32 KB)


class MatvecLaunch(NamedTuple):
    """One launch of the matvec kernel: ``rows`` rows of one batch entry
    per CTA, ``lanes`` threads reducing each. Short rows: the CTA's rows
    staged as one span, x at ``x_off``. Long rows: x staged ``xchunk``
    elements at a time at offset 0, the warps' partial sums at ``x_off``.
    x is staged raw, in its own dtype, as a span of its own."""
    short: bool
    rows: int
    threads: int
    lanes: int
    rot: int
    xchunk: int
    grid: tuple[int, int]     # (CTAs per batch entry, batch entries)
    smem: int
    x_off: int


@functools.lru_cache(maxsize=1024)
def matvec_launch_plan(B: int, M: int, K: int, a_dtype: torch.dtype,
                       x_dtype: torch.dtype) -> MatvecLaunch:
    """The mode and CTA shape of one launch over ``B`` batch entries of an
    ``M × K`` A of ``a_dtype`` against x of ``x_dtype``.

    Rows of at most ``SHORT_ROW_BYTES`` take the short-row mode, planned by
    ``kernels.staged_rows`` (rows per CTA a power of two up to 128, at
    least ``min(132, B·M)`` CTAs, shared memory within 48 KB). Longer rows
    take ``S`` warps each, the fewest (a power of two up to ``MAX_WARPS``)
    that leave a thread at most ``PREFETCH`` 16-byte chunks of a row's
    ``xchunk`` elements (x is staged in chunks of at most ``X_CHUNK``),
    and ``MAX_WARPS / S`` rows a CTA, halved while there are fewer than
    ``min(132, B·M)`` CTAs but not below ``MIN_ROWS``: every CTA stages
    its own x, which one-row CTAs would read once per row (measured slower
    at the reference's 256×512 and 512×1024)."""
    es = a_dtype.itemsize
    want = min(MIN_CTAS, B * M)
    if K * es <= SHORT_ROW_BYTES:
        p = staged_rows(B, M, K, es, span_bytes(1, K, x_dtype.itemsize))
        return MatvecLaunch(short=True, rows=p.rows, threads=p.threads,
                            lanes=p.lanes, rot=p.rot, xchunk=K, grid=p.grid,
                            smem=p.smem, x_off=p.x_off)
    xchunk = min(K, X_CHUNK)
    chunks = -(-xchunk * es // 16)
    S = 1
    while S < MAX_WARPS and 32 * PREFETCH * S < chunks:
        S *= 2
    rows = MAX_WARPS // S
    while rows > MIN_ROWS and -(-M // rows) * B < want:
        rows //= 2
    threads = 32 * S * rows
    x_off = span_bytes(1, xchunk, x_dtype.itemsize)
    return MatvecLaunch(short=False, rows=rows, threads=threads,
                        lanes=32 * S, rot=0, xchunk=xchunk,
                        grid=(-(-M // rows), B), smem=x_off + threads // 8,
                        x_off=x_off)


class _Args(ctypes.Structure):
    """The kernel's launch arguments (``MatvecArgs`` in the CUDA source,
    same field order), packed once per signature and passed by address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "M", "K", "short_rows", "rows", "threads", "lanes", "rot",
        "xchunk", "smem", "x_off", "grid_x", "a_bf16", "x_bf16")]


def splitk_matvec_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: A (…, M, K), x (…, K) → (…, M) float32."""
    return (a.to(torch.float32) * x.to(torch.float32)[..., None, :]).sum(-1)


@functools.lru_cache(maxsize=256)
def _signature(a_shape, x_shape, a_dtype, x_dtype) -> Signature:
    """The checks, output shape, refusal and packed launch arguments of one
    shape and dtype signature (a raise is not cached)."""
    if a_dtype not in DTYPES or x_dtype not in DTYPES:
        raise TypeError(f"splitk_matvec takes float32 or bfloat16, got "
                        f"{a_dtype} and {x_dtype}")
    if len(a_shape) not in (2, 3) or len(x_shape) != len(a_shape) - 1:
        raise ValueError(f"splitk_matvec takes (M, K) and (K,), or batched "
                         f"(B, M, K) and (B, K); got {tuple(a_shape)} and "
                         f"{tuple(x_shape)}")
    if a_shape[:-2] != x_shape[:-1] or a_shape[-1] != x_shape[-1]:
        raise ValueError(f"operand shapes {tuple(a_shape)} and "
                         f"{tuple(x_shape)} disagree on batch or K")
    nb = a_shape[0] if len(a_shape) == 3 else 1
    M, K = a_shape[-2:]
    out_shape = tuple(a_shape[:-1])
    if max(M, K) >= 1 << 31 or nb > 65535:
        return Signature(out_shape, torch.float32, 0,
                         f"splitk_matvec shape {(nb, M, K)} exceeds the "
                         f"kernel's index range", None, 0)
    if nb * M == 0:
        return Signature(out_shape, torch.float32, 0, None, None, 0)
    p = matvec_launch_plan(nb, M, K, a_dtype, x_dtype)
    args = _Args(nb, M, K, int(p.short), p.rows, p.threads, p.lanes, p.rot,
                 p.xchunk, p.smem, p.x_off, p.grid[0],
                 int(a_dtype == torch.bfloat16),
                 int(x_dtype == torch.bfloat16))
    return Signature(out_shape, torch.float32, nb * M, None, args,
                     ctypes.addressof(args))


def splitk_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, f32 accumulate: A (M, K), x (K,) → (M,) float32, or
    batched (B, M, K), (B, K) → (B, M).

    CUDA tensors go to the kernel (one launch; ``splitk_matvec.launches``
    counts launches), CPU tensors to :func:`splitk_matvec_plain`.
    """
    sig = _signature(a.shape, x.shape, a.dtype, x.dtype)
    y = launch(splitk_matvec, sig, a, x, SOURCE, SYMBOL)
    return splitk_matvec_plain(a, x) if y is None else y


splitk_matvec.launches = 0
