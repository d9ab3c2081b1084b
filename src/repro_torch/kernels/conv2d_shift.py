"""Shift-and-add 2D convolutions — MatPIM §III-A and §III-C on the GPU.

The port of ``src/repro/kernels/conv2d_shift.py``. MatPIM builds A ⊗ K as
the sum of shifted copies of A scaled by single kernel elements, so no
im2col buffer is ever built; each function here is a valid
cross-correlation (no flip) with f32 accumulation:

* :func:`conv2d_shift`       — the whole image per call;
* :func:`conv2d_shift_tiled` — the output tiled bh×bw with halo input tiles
  (the output must tile evenly, as in the reference);
* :func:`binary_conv2d`      — ±1 conv over channel-packed int32 words,
  ``kh·kw·C − 2·Σ popcount(a ^ k)``.

CUDA tensors go to the hand-written kernels in ``csrc/conv2d_shift.cu``
(the note there says what bounds them and how the TPU kernels map to
Hopper), CPU tensors to the ``*_plain`` versions beside each wrapper. There
is no fallback from one to the other. Each wrapper counts its launches in
``<wrapper>.launches``.

The float convs take an optional leading batch axis: images ``(B, H, W)``
with one kernel ``(kh, kw)`` for all or one per image ``(B, kh, kw)``,
giving ``(B, OH, OW)``; each batch entry is the TPU kernel's function, and
the CUDA kernel serves the whole batch in one launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import load_library
from .binary_matmul import popcount32

SOURCE = "conv2d_shift.cu"
DTYPES = (torch.float32, torch.bfloat16)
# shared memory a block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448


def conv2d_shift_plain(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a (…, H, W), k (…, kh, kw) → (…, OH, OW)
    float32, the k² shifted multiply-adds in tap order."""
    H, W = a.shape[-2:]
    kh, kw = k.shape[-2:]
    OH, OW = H - kh + 1, W - kw + 1
    acc = torch.zeros(a.shape[:-2] + (OH, OW), dtype=torch.float32,
                      device=a.device)
    for v in range(kh):
        for h in range(kw):
            acc = acc + a[..., v:v + OH, h:h + OW].to(torch.float32) \
                * k[..., v, h, None, None].to(torch.float32)
    return acc


def _check_conv(name: str, a: torch.Tensor, k: torch.Tensor) -> None:
    if a.dtype not in DTYPES or k.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {a.dtype} "
                        f"and {k.dtype}")
    if not ((a.ndim == 2 and k.ndim == 2)
            or (a.ndim == 3 and k.ndim in (2, 3))):
        raise ValueError(f"{name} takes (H, W) and (kh, kw), or batched "
                         f"(B, H, W) and (kh, kw) or (B, kh, kw); got "
                         f"{tuple(a.shape)} and {tuple(k.shape)}")
    if k.ndim == 3 and k.shape[0] != a.shape[0]:
        raise ValueError(f"{k.shape[0]} kernels for {a.shape[0]} images")
    if k.shape[-2] > a.shape[-2] or k.shape[-1] > a.shape[-1] \
            or min(k.shape[-2:]) < 1:
        raise ValueError(f"kernel {tuple(k.shape[-2:])} does not fit the "
                         f"image {tuple(a.shape[-2:])}")
    if a.device != k.device:
        raise ValueError(f"operands on {a.device} and {k.device}")


def _cuda_ready(name: str, *ts: torch.Tensor) -> bool:
    """True for CUDA operands on the current card, False for CPU operands;
    raises for anything else."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or the CPU, not {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous operands")
    return True


def _launch_conv(entry, a, k, out, *extra) -> None:
    batched = a.ndim == 3
    nb = a.shape[0] if batched else 1
    H, W = a.shape[-2:]
    kh, kw = k.shape[-2:]
    if max(H * W, nb) >= 1 << 31 or nb > 65535:
        raise ValueError(f"conv shape {(nb, H, W)} exceeds the kernel's "
                         f"index range")
    err = entry(a.data_ptr(), k.data_ptr(), out.data_ptr(), nb, H, W, kh, kw,
                int(k.ndim == 3), int(a.dtype == torch.bfloat16),
                int(k.dtype == torch.bfloat16), *extra,
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv2d_shift launch failed: CUDA error {err}")


def conv2d_shift(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation, f32 accumulate: a (H, W), k (kh, kw) →
    (H−kh+1, W−kw+1) float32, or batched a (B, H, W) with k (kh, kw) or
    (B, kh, kw) → (B, OH, OW).

    CUDA tensors go to the kernel (one launch; ``conv2d_shift.launches``
    counts launches), CPU tensors to :func:`conv2d_shift_plain`.
    """
    _check_conv("conv2d_shift", a, k)
    if not _cuda_ready("conv2d_shift", a, k):
        return conv2d_shift_plain(a, k)
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):    # launch on the operands' card
            return conv2d_shift(a, k)
    OH, OW = a.shape[-2] - k.shape[-2] + 1, a.shape[-1] - k.shape[-1] + 1
    out = torch.empty(a.shape[:-2] + (OH, OW), dtype=torch.float32,
                      device=a.device)
    if out.numel():
        _launch_conv(_entries()[0], a, k, out)
        conv2d_shift.launches += 1
    return out


conv2d_shift.launches = 0


def tile_shape(a_shape, k_shape, bh: int = 128, bw: int = 128):
    """The reference's tile contract: ``(bh, bw)`` clamped to the output,
    which must tile evenly (``ValueError`` otherwise)."""
    OH = a_shape[-2] - k_shape[-2] + 1
    OW = a_shape[-1] - k_shape[-1] + 1
    bh, bw = min(int(bh), OH), min(int(bw), OW)
    if bh < 1 or bw < 1:
        raise ValueError(f"tile {(bh, bw)} must be positive")
    if OH % bh or OW % bw:
        raise ValueError(f"output {(OH, OW)} must tile evenly by "
                         f"{(bh, bw)}; pad the input")
    return bh, bw


def conv2d_shift_tiled_plain(a: torch.Tensor, k: torch.Tensor,
                             bh: int = 128, bw: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv2d_shift_tiled`: the tile
    contract, then the same sums as :func:`conv2d_shift_plain` (tiling
    changes where the sums run, not what they are)."""
    tile_shape(a.shape, k.shape, bh, bw)
    return conv2d_shift_plain(a, k)


def conv2d_shift_tiled(a: torch.Tensor, k: torch.Tensor, bh: int = 128,
                       bw: int = 128) -> torch.Tensor:
    """Valid cross-correlation with the output tiled bh×bw and halo input
    tiles; shapes as :func:`conv2d_shift`. bh, bw clamp to the output,
    which must tile evenly (``ValueError`` otherwise: pad the input).

    CUDA tensors go to the kernel (one launch, one thread block per tile;
    ``conv2d_shift_tiled.launches`` counts launches), CPU tensors to
    :func:`conv2d_shift_tiled_plain`.
    """
    _check_conv("conv2d_shift_tiled", a, k)
    if not _cuda_ready("conv2d_shift_tiled", a, k):
        return conv2d_shift_tiled_plain(a, k, bh, bw)
    bh, bw = tile_shape(a.shape, k.shape, bh, bw)
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):    # launch on the operands' card
            return conv2d_shift_tiled(a, k, bh, bw)
    kh, kw = k.shape[-2:]
    smem = 4 * ((bh + kh - 1) * (bw + kw - 1) + kh * kw)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"tile {(bh, bw)} with a {(kh, kw)} kernel needs "
                         f"{smem} B of shared memory, over the "
                         f"{MAX_SMEM_BYTES} B a block may use; pass a "
                         f"smaller bh, bw")
    OH, OW = a.shape[-2] - kh + 1, a.shape[-1] - kw + 1
    if (OH // bh) > 65535:
        raise ValueError(f"{OH // bh} tile rows exceed the kernel's grid")
    out = torch.empty(a.shape[:-2] + (OH, OW), dtype=torch.float32,
                      device=a.device)
    if out.numel():
        _launch_conv(_entries()[1], a, k, out, bh, bw)
        conv2d_shift_tiled.launches += 1
    return out


conv2d_shift_tiled.launches = 0


def binary_conv2d_plain(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a (H, W, Cw), k (kh, kw, Cw) int32 words →
    (OH, OW) int32 ±1 dot over (kh, kw, 32·Cw)."""
    H, W, Cw = a.shape
    kh, kw, _ = k.shape
    OH, OW = H - kh + 1, W - kw + 1
    mism = torch.zeros((OH, OW), dtype=torch.int64, device=a.device)
    for v in range(kh):
        for h in range(kw):
            mism += popcount32(a[v:v + OH, h:h + OW, :] ^ k[v, h, :]).sum(-1)
    return (kh * kw * 32 * Cw - 2 * mism).to(torch.int32)


def binary_conv2d(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """±1 conv over channel-packed words (XNOR-Net style, MatPIM §III-C):
    a (H, W, C/32), k (kh, kw, C/32) int32 holding uint32 bits → (OH, OW)
    int32.

    CUDA tensors go to the kernel (one launch; ``binary_conv2d.launches``
    counts launches), CPU tensors to :func:`binary_conv2d_plain`.
    """
    if a.dtype != torch.int32 or k.dtype != torch.int32:
        raise TypeError(f"binary_conv2d takes int32 words, got {a.dtype} "
                        f"and {k.dtype}")
    if a.ndim != 3 or k.ndim != 3 or a.shape[-1] != k.shape[-1]:
        raise ValueError(f"binary_conv2d takes (H, W, Cw) and (kh, kw, Cw);"
                         f" got {tuple(a.shape)} and {tuple(k.shape)}")
    if k.shape[0] > a.shape[0] or k.shape[1] > a.shape[1] \
            or min(k.shape[:2]) < 1:
        raise ValueError(f"kernel {tuple(k.shape[:2])} does not fit the "
                         f"image {tuple(a.shape[:2])}")
    if a.device != k.device:
        raise ValueError(f"operands on {a.device} and {k.device}")
    if not _cuda_ready("binary_conv2d", a, k):
        return binary_conv2d_plain(a, k)
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):    # launch on the operands' card
            return binary_conv2d(a, k)
    H, W, Cw = a.shape
    kh, kw, _ = k.shape
    if a.numel() >= 1 << 31:
        raise ValueError(f"binary_conv2d shape {tuple(a.shape)} exceeds "
                         f"the kernel's index range")
    out = torch.empty((H - kh + 1, W - kw + 1), dtype=torch.int32,
                      device=a.device)
    if out.numel():
        err = _entries()[2](a.data_ptr(), k.data_ptr(), out.data_ptr(), H, W,
                            Cw, kh, kw,
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"binary_conv2d launch failed: CUDA error "
                               f"{err}")
        binary_conv2d.launches += 1
    return out


binary_conv2d.launches = 0


@functools.cache
def _entries():
    """The three C entry points (conv, tiled conv, binary conv), built and
    loaded at first use, with their ctypes signatures (pointers and the
    stream as ``c_void_p``)."""
    lib = load_library(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    conv = lib.matpim_conv2d_shift
    conv.argtypes = [P, P, P] + [I] * 8 + [P]
    tiled = lib.matpim_conv2d_shift_tiled
    tiled.argtypes = [P, P, P] + [I] * 10 + [P]
    binary = lib.matpim_binary_conv2d
    binary.argtypes = [P, P, P] + [I] * 5 + [P]
    for fn in (conv, tiled, binary):
        fn.restype = ctypes.c_int
    return conv, tiled, binary
