"""Public wrappers around the port's kernels (the port of
``src/repro/kernels/ops.py``).

The reference picks Pallas or its jnp oracles with ``use_pallas``; here the
operands' device picks the route: CUDA tensors launch the hand-written
kernels, CPU tensors take each kernel's plain PyTorch version (the kernel
wrappers decide, see ``binary_matmul.py``, ``splitk_matvec.py`` and
``conv2d_shift.py``). There is no ``use_pallas`` and no fallback between
the two.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref
from .binary_matmul import binary_matmul
from .conv2d_shift import binary_conv2d, conv2d_shift, conv2d_shift_tiled
from .splitk_matvec import splitk_matvec

pack_bits = ref.pack_bits


def as_packed_words(w) -> torch.Tensor:
    """Reinterpret a packed-bit word array as the int32 words the kernels
    take (each holding 32 bits, the reference's uint32 lanes).

    The simulator packs bits into whatever unsigned word width fits
    (uint8/16/32/64). This helper *views* the underlying bytes as
    little-endian 32-bit words (bit k of the wide word stays bit k of the
    word stream), so any unsigned width is accepted without a repack.

    Signed numpy arrays are rejected outright: an int32/int64 "packed"
    array is almost always an accidental upcast, and reinterpreting sign
    bits as payload would corrupt popcounts silently. A ``torch.int32``
    tensor is already the port's word form and passes through; torch
    unsigned tensors are viewed in place on their device.
    """
    if isinstance(w, torch.Tensor):
        if w.dtype == torch.int32:
            return w
        if w.dtype not in (torch.uint8, torch.uint16, torch.uint32,
                           torch.uint64):
            raise TypeError(
                f"packed words must be unsigned (uint8/16/32/64) or the "
                f"port's int32 words, got {w.dtype}")
        if w.ndim == 0 or (w.shape[-1] * w.element_size()) % 4:
            raise ValueError(
                f"last axis of {w.dtype} shape {tuple(w.shape)} is not a "
                f"whole number of 32-bit words")
        return w.contiguous().view(torch.int32)   # native order: little
    arr = np.asarray(w)
    if arr.dtype.kind != "u":
        raise TypeError(
            f"packed words must be unsigned (uint8/16/32/64), got "
            f"{arr.dtype}; an int32/int64 array here usually means an "
            f"accidental repack — view/cast it as unsigned upstream")
    if arr.ndim == 0 or (arr.shape[-1] * arr.dtype.itemsize) % 4:
        raise ValueError(
            f"last axis of {arr.dtype} shape {arr.shape} is not a whole "
            f"number of 32-bit words")
    le = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("<"),
                                         copy=False))
    return torch.from_numpy(le.view(np.dtype("<i4")).copy())


def binary_dense(x: torch.Tensor, w_packed, K: int) -> torch.Tensor:
    """±1 dense layer: x (..., K) real → sign-binarized → XNOR-GEMM vs packed
    weights w (N, K/32). Returns (..., N) int32 ±1 dot values, on x's
    device (the weights move there).
    """
    lead = x.shape[:-1]
    xp = pack_bits(x.reshape(-1, K), axis=-1)
    w = as_packed_words(w_packed).to(xp.device)
    return binary_matmul(xp, w).reshape(*lead, -1)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with f32 accumulation (``splitk_matvec``)."""
    return splitk_matvec(a, x)


def conv2d(a: torch.Tensor, k: torch.Tensor, tiled: bool = False
           ) -> torch.Tensor:
    """Valid cross-correlation (``conv2d_shift``, or ``conv2d_shift_tiled``
    under the reference's default 128×128 tile contract: the same kernel,
    whose CTA tiles the launch plan chooses for the card either way)."""
    fn = conv2d_shift_tiled if tiled else conv2d_shift
    return fn(a, k)


def conv2d_binary(a_packed, k_packed) -> torch.Tensor:
    """±1 conv over channel-packed words (``binary_conv2d``); the words may
    be any unsigned width (see :func:`as_packed_words`)."""
    a = as_packed_words(a_packed)
    return binary_conv2d(a, as_packed_words(k_packed).to(a.device))


__all__ = ["as_packed_words", "binary_dense", "conv2d", "conv2d_binary",
           "matvec", "pack_bits"]
