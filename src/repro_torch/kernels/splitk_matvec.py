"""Split-K matrix-vector product — MatPIM §II-A on the GPU.

The port of ``src/repro/kernels/splitk_matvec.py``. MatPIM splits the
contraction axis into α blocks computed in parallel row bands and
tree-reduces the partial vectors; the TPU kernel runs the same split as a
sequential k-grid. :func:`splitk_matvec` computes ``y = A @ x`` with float32
accumulation (A and x each float32 or bfloat16): CUDA tensors go to the
hand-written kernel in ``csrc/splitk_matvec.cu`` (the note there says what
bounds it and how the sequential k-grid maps to Hopper), CPU tensors to
:func:`splitk_matvec_plain`, the same function in plain PyTorch. There is
no fallback from one to the other.

Both versions take an optional leading batch axis, A ``(B, M, K)`` and x
``(B, K)`` giving ``(B, M)``; each batch entry is the TPU kernel's function,
and the CUDA kernel serves the whole batch in one launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import load_library

SOURCE = "splitk_matvec.cu"
DTYPES = (torch.float32, torch.bfloat16)


def splitk_matvec_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: A (…, M, K), x (…, K) → (…, M) float32."""
    return (a.to(torch.float32) * x.to(torch.float32)[..., None, :]).sum(-1)


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.dtype not in DTYPES or x.dtype not in DTYPES:
        raise TypeError(f"splitk_matvec takes float32 or bfloat16, got "
                        f"{a.dtype} and {x.dtype}")
    if a.ndim not in (2, 3) or x.ndim != a.ndim - 1:
        raise ValueError(f"splitk_matvec takes (M, K) and (K,), or batched "
                         f"(B, M, K) and (B, K); got {tuple(a.shape)} and "
                         f"{tuple(x.shape)}")
    if a.shape[:-2] != x.shape[:-1] or a.shape[-1] != x.shape[-1]:
        raise ValueError(f"operand shapes {tuple(a.shape)} and "
                         f"{tuple(x.shape)} disagree on batch or K")
    if a.device != x.device:
        raise ValueError(f"operands on {a.device} and {x.device}")


def splitk_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, f32 accumulate: A (M, K), x (K,) → (M,) float32, or
    batched (B, M, K), (B, K) → (B, M).

    CUDA tensors go to the kernel (one launch; ``splitk_matvec.launches``
    counts launches), CPU tensors to :func:`splitk_matvec_plain`.
    """
    _check(a, x)
    if a.device.type == "cpu":
        return splitk_matvec_plain(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"splitk_matvec runs on CUDA or the CPU, not "
                         f"{a.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("splitk_matvec takes contiguous operands")
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):    # launch on the operands' card
            return splitk_matvec(a, x)
    batched = a.ndim == 3
    a3 = a if batched else a[None]
    x2 = x if batched else x[None]
    nb, M, K = a3.shape
    if max(M, K) >= 1 << 31 or nb > 65535:
        raise ValueError(f"splitk_matvec shape {(nb, M, K)} exceeds the "
                         f"kernel's index range")
    y = torch.empty((nb, M), dtype=torch.float32, device=a.device)
    if y.numel():
        err = _entry()(a3.data_ptr(), x2.data_ptr(), y.data_ptr(), nb, M, K,
                       int(a.dtype == torch.bfloat16),
                       int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"splitk_matvec launch failed: CUDA error "
                               f"{err}")
        splitk_matvec.launches += 1
    return y if batched else y[0]


splitk_matvec.launches = 0


@functools.cache
def _entry():
    """The C entry point, built and loaded at first use, with its ctypes
    signature (pointers and the stream as ``c_void_p``)."""
    fn = load_library(SOURCE).matpim_splitk_matvec
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
