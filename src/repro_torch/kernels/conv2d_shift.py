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

:func:`binary_conv2d` takes the same host path, with its launch chosen by
:func:`binary_conv_launch_plan`: lanes grouped per output over the
channel words, CTA tiles that fill the card, and either every output's
units spread over its lanes (small launches) or each halo row's units
loaded once for several output rows (launches that fill the card).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import Signature, _round_up, launch, span_bytes
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

# binary_conv2d's launch plan (binary_conv_launch_plan)
BINARY_SYMBOL = "matpim_binary_conv2d"
BCONV_THREADS = 256   # the most threads a binary conv CTA has
BCONV_Q = 4           # output rows per lane group under row reuse (the
                      # kernel's kReuseRows)
REUSE_KH = (2, 5)     # kernel heights compiled for row reuse
LANE_WASTE = 8        # a group idles at most 1/LANE_WASTE of its unit slots
BCONV_MIN_CTAS = 132  # launches below this many CTAs spread units instead
BCONV_STAGE_TAPS = 9  # row reuse over kernels of more taps stages halo tiles


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


class BinaryConvPlan(NamedTuple):
    """One launch of the binary conv kernel: ``TH × TW`` output tiles, a
    group of ``G`` lanes per output with ``Q`` outputs (consecutive rows)
    per group, units of ``V`` words, row reuse or unit spread; staged halo
    rows lie ``pitch`` words apart in shared memory, the taps from
    ``taps_off`` bytes on."""
    V: int
    G: int
    reuse: bool
    Q: int
    TH: int
    TW: int
    threads: int
    staged: bool
    pitch: int
    grid: tuple[int, int]     # (row tiles, column tiles)
    smem: int
    taps_off: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _lanes(n: int) -> int:
    """Lanes sharing ``n`` units: the largest power of two up to a warp
    that idles at most ``1/LANE_WASTE`` of its ``ceil(n/G)·G`` slots."""
    G = 32
    while G > 1 and -(-n // G) * G * LANE_WASTE > (LANE_WASTE + 1) * n:
        G //= 2
    return G


def _bconv_tile(OH: int, OW: int, groups: int, Q: int):
    """(TH, TW, grid) of ``groups`` lane groups of ``Q`` output rows: the
    widest power-of-two TW up to the square root of the tile's outputs (a
    compact halo), at most ``groups`` and no wider than OW needs."""
    TW = 1
    while (2 * TW) ** 2 <= groups * Q and 2 * TW <= groups and TW < OW:
        TW *= 2
    TH = groups // TW * Q
    return TH, TW, (-(-OH // TH), -(-OW // TW))


def _bconv_smem(TH: int, TW: int, Cw: int, kh: int, kw: int, V: int):
    """(pitch, taps_off, smem) of a staged tile: each halo row (its span
    lands up to 3 words late) padded to 16 bytes and, for units of 4 words,
    to a pitch ≡ kw·Cw (mod 32 words), so a group's units that run on into
    the next halo row stay on consecutive banks; the taps staged as one
    span after them."""
    pitch = _round_up((TW + kw - 1) * Cw + 3, 4)
    while V == 4 and (pitch - kw * Cw) % 32:
        pitch += 4
    taps_off = 4 * pitch * (TH + kh - 1)
    return pitch, taps_off, taps_off + span_bytes(1, kh * kw * Cw, 4)


@functools.lru_cache(maxsize=1024)
def binary_conv_launch_plan(OH: int, OW: int, Cw: int, kh: int,
                            kw: int) -> BinaryConvPlan:
    """The launch of ``binary_conv2d`` over an ``OH × OW`` output of
    ``Cw``-word channels with a ``kh × kw`` kernel.

    An output's work is ``kh`` runs of ``kw·Cw`` words, ``LU`` units of
    ``V`` words each (4 where ``Cw % 4 == 0``, read as ``uint4``).

    * Row reuse, for ``kh`` in ``REUSE_KH`` when it gives at least
      ``BCONV_MIN_CTAS`` CTAs: a group of ``_lanes(LU)`` lanes owns
      ``BCONV_Q`` output rows of a column; each lane loads each of its
      units of the ``BCONV_Q + kh − 1`` halo rows once and counts it for
      every output row that uses it. CTAs of ``BCONV_THREADS`` threads
      (fewer where that lets a staged tile fit ``SMEM_BYTES``).
    * Otherwise unit spread: a group of ``_lanes(kh·LU)`` lanes per output
      (``Q = 1``); threads halve from ``BCONV_THREADS`` to one warp while
      there are fewer than ``BCONV_MIN_CTAS`` CTAs (a warp-sized CTA holds
      ``32/G`` outputs, so ``OH·OW ≥ 132·32/G`` gives at least 132).

    Row reuse over kernels of more than ``BCONV_STAGE_TAPS`` taps stages
    each CTA's halo rows and taps in shared memory (the most threads whose
    tile fits ``SMEM_BYTES``); every other launch reads A and K through L1,
    where loads and counts of the resident warps overlap and staging, whose
    copies all finish before any count starts, measured slower (PERF.md).
    """
    V = 4 if Cw % 4 == 0 else 1
    LU = kw * Cw // V
    stage = kh * kw > BCONV_STAGE_TAPS

    def plan_for(G, Q, threads):
        TH, TW, grid = _bconv_tile(OH, OW, threads // G, Q)
        pitch, taps_off, smem = _bconv_smem(TH, TW, Cw, kh, kw, V)
        staged = Q > 1 and stage and smem <= SMEM_BYTES
        if not staged:
            pitch = taps_off = smem = 0
        return BinaryConvPlan(V=V, G=G, reuse=Q > 1, Q=Q, TH=TH, TW=TW,
                              threads=threads, staged=staged, pitch=pitch,
                              grid=grid, smem=smem, taps_off=taps_off)

    sizes = [BCONV_THREADS >> i for i in range(BCONV_THREADS.bit_length())
             if BCONV_THREADS >> i >= 32]
    if REUSE_KH[0] <= kh <= REUSE_KH[1]:
        plans = [plan_for(_lanes(LU), BCONV_Q, n) for n in sizes]
        plans = [p for p in plans if p.ctas >= BCONV_MIN_CTAS]
        if plans:
            return next((p for p in plans if p.staged), plans[0])
    G = _lanes(kh * LU)
    plans = [plan_for(G, 1, n) for n in sizes]
    return next((p for p in plans if p.ctas >= BCONV_MIN_CTAS), plans[-1])


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


class _BinaryArgs(ctypes.Structure):
    """The binary kernel's launch arguments (``BconvArgs`` in the CUDA
    source, same field order), packed once per signature."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "H", "W", "Cw", "kh", "kw", "OH", "OW", "V", "lg", "reuse", "Q", "TH",
        "TW", "threads", "staged", "pitch", "smem", "taps_off", "grid_x",
        "grid_y")]


@functools.lru_cache(maxsize=256)
def _binary_signature(a_shape, k_shape, a_dtype, k_dtype) -> Signature:
    """The binary conv's checks, output shape, refusal and packed launch
    arguments of one shape and dtype signature (a raise is not cached)."""
    if a_dtype != torch.int32 or k_dtype != torch.int32:
        raise TypeError(f"binary_conv2d takes int32 words, got {a_dtype} "
                        f"and {k_dtype}")
    if len(a_shape) != 3 or len(k_shape) != 3 or a_shape[-1] != k_shape[-1]:
        raise ValueError(f"binary_conv2d takes (H, W, Cw) and (kh, kw, Cw);"
                         f" got {tuple(a_shape)} and {tuple(k_shape)}")
    (H, W, Cw), (kh, kw) = a_shape, k_shape[:2]
    if kh > H or kw > W or min(kh, kw) < 1:
        raise ValueError(f"kernel {(kh, kw)} does not fit the image "
                         f"{(H, W)}")
    OH, OW = H - kh + 1, W - kw + 1
    if H * W * max(Cw, 1) >= 1 << 31:     # image words, and outputs
        return Signature((OH, OW), torch.int32, 0,
                         f"binary_conv2d shape {tuple(a_shape)} exceeds the "
                         f"kernel's index range", None, 0)
    p = binary_conv_launch_plan(OH, OW, Cw, kh, kw)
    if p.grid[1] > 65535:
        return Signature((OH, OW), torch.int32, 0,
                         f"binary_conv2d output width {OW} exceeds the "
                         f"kernel's index range", None, 0)
    args = _BinaryArgs(H, W, Cw, kh, kw, OH, OW, p.V, p.G.bit_length() - 1,
                       int(p.reuse), p.Q, p.TH, p.TW, p.threads,
                       int(p.staged), p.pitch, p.smem, p.taps_off, *p.grid)
    return Signature((OH, OW), torch.int32, OH * OW, None, args,
                     ctypes.addressof(args))


def binary_conv2d(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """±1 conv over channel-packed words (XNOR-Net style, MatPIM §III-C):
    a (H, W, C/32), k (kh, kw, C/32) int32 holding uint32 bits → (OH, OW)
    int32.

    CUDA tensors go to the kernel (one launch; ``binary_conv2d.launches``
    counts launches), CPU tensors to :func:`binary_conv2d_plain`.
    """
    sig = _binary_signature(a.shape, k.shape, a.dtype, k.dtype)
    out = launch(binary_conv2d, sig, a, k, SOURCE, BINARY_SYMBOL)
    return binary_conv2d_plain(a, k) if out is None else out


binary_conv2d.launches = 0
