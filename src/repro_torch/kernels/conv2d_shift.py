"""Shift-and-add 2D convolutions — MatPIM §III-A and §III-C on the GPU.

The port of ``src/repro/kernels/conv2d_shift.py``. MatPIM builds A ⊗ K as
the sum of shifted copies of A scaled by single kernel elements, so no
im2col buffer is ever built; each function here is a valid
cross-correlation (no flip) with f32 accumulation:

* :func:`conv2d_shift`       — the whole image per call;
* :func:`conv2d_shift_tiled` — the reference's bh×bw output tiling, whose
  contract it keeps (the output must tile evenly) while computing the same
  output;
* :func:`binary_conv2d`      — ±1 conv over channel-packed int32 words,
  ``kh·kw·C − 2·Σ popcount(a ^ k)``.

CUDA tensors go to the hand-written kernels in ``csrc/conv2d_shift.cu``
(the note there says what bounds them and how the TPU kernels map to
Hopper), CPU tensors to the ``*_plain`` versions beside each wrapper. There
is no fallback from one to the other. Each wrapper counts its launches in
``<wrapper>.launches``.

The float convs take an optional leading batch axis: images ``(B, H, W)``
with one kernel ``(kh, kw)`` for all or one per image ``(B, kh, kw)``,
giving ``(B, OH, OW)``; each batch entry is the TPU kernel's function. Both
run one CUDA kernel, one launch per call, whose CTA tiling is chosen for the
card by :func:`conv_launch_plan`, not taken from the reference's ``bh×bw``
(a TPU block size). The host path is lean: everything that depends only on
the shapes and dtypes — the checks, the output shape and the packed launch
arguments — is computed once per signature and cached, so a call makes a
few device and layout checks, one ``new_empty`` and one ctypes call
(``kernels.launch``, shared with ``splitk_matvec`` and ``binary_matmul``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import Signature, _round_up, launch, load_library
from .binary_matmul import popcount32

SOURCE = "conv2d_shift.cu"
SYMBOL = "matpim_conv2d_shift"
DTYPES = (torch.float32, torch.bfloat16)

# The launch plan's constants, for the H100 SXM (PERF.md has the times of
# the alternatives).
STRIP = 4             # output rows per thread (the kernel's register strip)
TALL_STRIP = 8        # ... in images of TALL_STRIP_OUTPUTS, read directly
MAX_THREADS = 256     # the most threads a conv CTA has
SPLIT_OUTPUTS = 512   # a CTA is not split below this many outputs ...
MIN_CTAS = 2 * 132    # ... once there are two CTAs per SM (132 SMs)
# enough outputs for MIN_CTAS CTAs of MAX_THREADS tall strips
TALL_STRIP_OUTPUTS = MIN_CTAS * MAX_THREADS * TALL_STRIP
MAX_TILE_W = 128      # the widest CTA tile, in output columns
MAX_IMAGES = 64       # images per CTA (the block's z extent)
STAGE_TAPS = 9        # kernels of more taps stage halo tiles in shared
DIRECT_CTAS = 132     # memory, in launches of at least this many CTAs
SMEM_BYTES = 48 * 1024   # dynamic shared memory a block gets with no opt-in


class LaunchPlan(NamedTuple):
    """One launch of the float conv kernel: ``TH × TW`` output tiles of
    ``images_per_cta`` images per CTA, ``R`` rows per thread; staged halo
    rows lie ``pitch`` elements apart in shared memory."""
    TH: int
    TW: int
    images_per_cta: int
    R: int
    staged: bool              # halo tiles through shared memory
    pitch: int
    block: tuple[int, int, int]   # (TW, TH / R, images_per_cta) threads
    grid: tuple[int, int]     # (row tiles × column tiles, image groups)
    smem: int                 # dynamic shared memory, bytes
    taps_off: int             # where the f32 taps start in it

    @property
    def threads(self) -> int:
        return math.prod(self.block)


@functools.lru_cache(maxsize=1024)
def conv_launch_plan(OH: int, OW: int, B: int, kh: int, kw: int,
                     dtype: torch.dtype) -> LaunchPlan:
    """The CTA tiling of one conv launch over ``B`` images with ``OH × OW``
    outputs each, for an ``A`` of ``dtype``.

    Each thread owns a strip of ``R`` rows of one output column (``STRIP``;
    ``TALL_STRIP`` for kernels read directly in images of
    ``TALL_STRIP_OUTPUTS`` outputs or more), so a CTA tile is ``TH = R·s``
    rows by ``TW ≤ MAX_TILE_W`` columns, at most ``MAX_THREADS`` strips.
    Tiles shrink in height until there are ``MIN_CTAS`` CTAs or a CTA is
    down to ``SPLIT_OUTPUTS`` outputs; images whose tile gives fewer than 64
    threads share a CTA (``images_per_cta``), up to ``SPLIT_OUTPUTS``
    outputs. So a CTA computes at most 512 outputs whenever there are fewer
    than ``MIN_CTAS``: ``B·OH·OW ≥ 132·512`` gives at least 132 CTAs.

    Kernels of at most ``STAGE_TAPS`` taps (3×3 and smaller) read A straight
    from global memory through L1: the strip already reuses each value in
    registers, and a staging barrier costs more than it saves. Larger
    kernels read each pixel more often and stage halo tiles in shared
    memory, unless the launch has fewer than ``DIRECT_CTAS`` CTAs (one per
    SM at most, so no CTA's staging would overlap another's work) or its
    halo tiles and taps would not fit ``SMEM_BYTES``: then it reads A
    directly too.
    """
    es = dtype.itemsize
    many_taps = kh * kw > STAGE_TAPS
    R = STRIP if many_taps or OH * OW < TALL_STRIP_OUTPUTS else TALL_STRIP
    ncol = -(-OW // MAX_TILE_W)
    TW = OW if ncol == 1 else _round_up(-(-OW // ncol), 8)
    ncol = -(-OW // TW)
    strips = -(-OH // R)
    s = min(strips, max(1, MAX_THREADS // TW))

    def ctas(s):
        return -(-strips // s) * ncol * B

    while s > 1 and TW * s * R > SPLIT_OUTPUTS and ctas(s) < MIN_CTAS:
        s = -(-s // 2)
    ipc = 1
    if TW * s < 64:
        ipc = max(1, min(B, MAX_IMAGES, SPLIT_OUTPUTS // (TW * s * R)))
    TH = R * s

    grid = (-(-OH // TH) * ncol, -(-B // ipc))
    pitch = _round_up((TW + kw - 1) * es, 16) // es
    taps_off = ipc * (TH + kh - 1) * pitch * es
    smem = taps_off + 4 * ipc * kh * kw
    staged = (many_taps and grid[0] * grid[1] >= DIRECT_CTAS
              and smem <= SMEM_BYTES)
    if not staged:
        pitch = smem = taps_off = 0
    return LaunchPlan(
        TH=TH, TW=TW, images_per_cta=ipc, R=R, staged=staged, pitch=pitch,
        block=(TW, s, ipc), grid=grid, smem=smem, taps_off=taps_off)


class _Args(ctypes.Structure):
    """The kernel's launch arguments (``ConvArgs`` in the CUDA source, same
    field order), packed once per signature and passed by address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "H", "W", "kh", "kw", "OH", "OW", "TH", "TW", "ipc", "R",
        "staged", "pitch", "ncol", "smem", "taps_off", "grid_x", "grid_y",
        "k_batched", "a_bf16", "k_bf16")]


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


@functools.lru_cache(maxsize=256)
def _signature(name: str, a_shape, k_shape, a_dtype, k_dtype,
               tile=None) -> Signature:
    """Everything a call needs that depends only on shapes and dtypes,
    checked and computed once: raises ``TypeError`` / ``ValueError`` on
    operands neither version takes (a raise is not cached), else gives the
    output shape, why the kernel would refuse the shape (its index range),
    and the packed launch arguments. ``tile`` is the tiled wrapper's
    ``(bh, bw)``."""
    if a_dtype not in DTYPES or k_dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {a_dtype} "
                        f"and {k_dtype}")
    an, kn = len(a_shape), len(k_shape)
    if not ((an == 2 and kn == 2) or (an == 3 and kn in (2, 3))):
        raise ValueError(f"{name} takes (H, W) and (kh, kw), or batched "
                         f"(B, H, W) and (kh, kw) or (B, kh, kw); got "
                         f"{tuple(a_shape)} and {tuple(k_shape)}")
    if kn == 3 and k_shape[0] != a_shape[0]:
        raise ValueError(f"{k_shape[0]} kernels for {a_shape[0]} images")
    (H, W), (kh, kw) = a_shape[-2:], k_shape[-2:]
    if kh > H or kw > W or min(kh, kw) < 1:
        raise ValueError(f"kernel {(kh, kw)} does not fit the image "
                         f"{(H, W)}")
    nb = a_shape[0] if an == 3 else 1
    OH, OW = H - kh + 1, W - kw + 1
    out_shape = tuple(a_shape[:-2]) + (OH, OW)
    if tile is not None:
        tile_shape(a_shape, k_shape, *tile)
    refusal = None
    if max(H * W, nb) >= 1 << 31 or nb > 65535:
        refusal = (f"conv shape {(nb, H, W)} exceeds the kernel's index "
                   f"range")
    if refusal or nb * OH * OW == 0:
        return Signature(out_shape, torch.float32, 0, refusal, None, 0)
    plan = conv_launch_plan(OH, OW, nb, kh, kw, a_dtype)
    args = _Args(nb, H, W, kh, kw, OH, OW, plan.TH, plan.TW,
                 plan.images_per_cta, plan.R, int(plan.staged), plan.pitch,
                 -(-OW // plan.TW), plan.smem, plan.taps_off, *plan.grid,
                 int(kn == 3),
                 int(a_dtype == torch.bfloat16),
                 int(k_dtype == torch.bfloat16))
    return Signature(out_shape, torch.float32, nb * OH * OW, None, args,
                     ctypes.addressof(args))


def _conv(wrapper, a: torch.Tensor, k: torch.Tensor, tile=None):
    """The float convs' shared path: the checks, then one launch for CUDA
    operands (counted on ``wrapper``), or ``None`` for CPU operands."""
    sig = _signature(wrapper.__name__, a.shape, k.shape, a.dtype, k.dtype,
                     tile)
    return launch(wrapper, sig, a, k, SOURCE, SYMBOL)


def conv2d_shift(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation, f32 accumulate: a (H, W), k (kh, kw) →
    (H−kh+1, W−kw+1) float32, or batched a (B, H, W) with k (kh, kw) or
    (B, kh, kw) → (B, OH, OW).

    CUDA tensors go to the kernel (one launch; ``conv2d_shift.launches``
    counts launches), CPU tensors to :func:`conv2d_shift_plain`.
    """
    out = _conv(conv2d_shift, a, k)
    return conv2d_shift_plain(a, k) if out is None else out


conv2d_shift.launches = 0


def conv2d_shift_tiled_plain(a: torch.Tensor, k: torch.Tensor,
                             bh: int = 128, bw: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv2d_shift_tiled`: the tile
    contract, then the same sums as :func:`conv2d_shift_plain` (tiling
    changes where the sums run, not what they are)."""
    tile_shape(a.shape, k.shape, bh, bw)
    return conv2d_shift_plain(a, k)


def conv2d_shift_tiled(a: torch.Tensor, k: torch.Tensor, bh: int = 128,
                       bw: int = 128) -> torch.Tensor:
    """Valid cross-correlation under the reference's output tiling; shapes
    as :func:`conv2d_shift`. bh, bw clamp to the output, which must tile
    evenly (``ValueError`` otherwise: pad the input); any such tiling runs.

    CUDA tensors go to the same kernel as :func:`conv2d_shift`, whose CTA
    tiles are chosen for the card (:func:`conv_launch_plan`), not bh×bw (one
    launch; ``conv2d_shift_tiled.launches`` counts launches), CPU tensors to
    :func:`conv2d_shift_tiled_plain`.
    """
    out = _conv(conv2d_shift_tiled, a, k, (int(bh), int(bw)))
    return conv2d_shift_tiled_plain(a, k, bh, bw) if out is None else out


conv2d_shift_tiled.launches = 0


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
        err = _binary_entry()(a.data_ptr(), k.data_ptr(), out.data_ptr(), H, W,
                            Cw, kh, kw,
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"binary_conv2d launch failed: CUDA error "
                               f"{err}")
        binary_conv2d.launches += 1
    return out


binary_conv2d.launches = 0


@functools.cache
def _binary_entry():
    """The binary conv's C entry point, built and loaded at first use, with
    its ctypes signature (pointers and the stream as ``c_void_p``)."""
    fn = load_library(SOURCE).matpim_binary_conv2d
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
