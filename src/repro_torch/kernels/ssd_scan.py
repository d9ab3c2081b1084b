"""Mamba-2's chunked SSD scan in three launches of one hand-written kernel
library (``csrc/ssd_scan.cu``), on the prefill and forward path.

Replaces no TPU kernel: the reference's ``src/repro/models/mamba.py``
computes the scan in plain ``jnp``, which XLA fuses. The port's plain
version, ``models/mamba.py::_ssd`` (padded for a ragged last chunk by
:func:`~repro_torch.models.mamba.ssd_plain`), writes every intermediate to
device memory in float32: the ``(c, h, l, l)`` decay matrix three times
over, ``(c, l, h, n)``-sized products for its three-operand einsums, and a
Python loop over the chunks, about 100 launches and 4-5 GB a layer at a
5000-token prompt. :func:`ssd_scan` computes the same function: x ``(b, s,
h, p)``, dt ``(b, s, h)``, A ``(h,)``, B and C ``(b, s, n)``, D ``(h,)``
and an optional initial state ``(b, h, p, n)`` → y ``(b, s, h, p)`` in x's
dtype and the final state in float32. CUDA tensors go to the kernel, CPU
tensors to the plain version; there is no fallback from one to the other.
``models/mamba.py::ssd_chunked`` chooses between them by what it sees.

The arithmetic is float32 FMAs on the CUDA cores, no operand rounded to
TF32 or bfloat16 (bfloat16 x, B and C widen exactly); the cumulative sums
of ``dt·A`` and C·Bᵀ are summed in float64, so each decay is taken of an
exact difference where the plain version's float32 sums lose digits
(``tests/test_torch_ssd_scan.py`` holds the kernel's distance from float64
to at most twice the plain float32 path's).
A sequence of any length is taken: a ragged last chunk, or a sequence
shorter than the chunk, is masked in the kernel, its missing rows reading
as ``dt`` = 0 and zero x, B and C, as the plain version pads them.

What bounds it: float32 FMAs. ``2·s·L·n + 2·s·L·h·p + 4·s·h·p·n`` flops
(:func:`flops`), 21 GFLOP a 5000-token prompt at granite's h 64, p 64,
n 128 and chunk 256, 0.31 ms at 67 TFLOP/s, against 27 us for its
operands at 3.35 TB/s. The design (the source's note) keeps every
``L × L`` and ``(l, h, n)``-sized intermediate out of device memory and
spends its instructions on register-tiled FMAs; its scratch is the
chunks' cumulative sums, their states and one ``L × L`` C·Bᵀ a chunk,
shared by every head (:func:`scratch_elements`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _COUNT_LOCK, entry

SOURCE = "ssd_scan.cu"
SYMBOL = "matpim_ssd_scan"
DTYPES = (torch.float32, torch.bfloat16)   # x's, and y's
MAX_CHUNK = 256      # a chunk's rows: one a thread of the kernel's scan
MAX_GRID = 65535     # chunks and batch rows: the grid's y and z


class _Args(ctypes.Structure):
    """The kernel's launch arguments (``SsdArgs`` in the CUDA source, same
    field order), passed by address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "b", "s", "h", "p", "n", "chunk", "nchunks", "x_bf16", "bc_bf16",
        "has_init")] + [(name, ctypes.c_longlong) for name in (
            "x_sb", "x_ss", "b_sb", "b_ss", "c_sb", "c_ss", "dt_sb",
            "dt_ss")]


def scratch_elements(b: int, s: int, h: int, p: int, n: int,
                     chunk: int) -> int:
    """The scratch of one call, in float32 elements: each chunk's
    cumulative ``dt·A`` (``h·L`` in float64), its state (``h·p·n``, then
    the state before it) and its ``C·Bᵀ`` (``L·L``), with ``L = min(chunk,
    s)``."""
    L = min(chunk, s)
    return b * (-(-s // L)) * (2 * h * L + h * p * n + L * L)


def flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """The scan's work as ``bench/flops.py`` counts it: ``2·T·L·n`` for
    C·Bᵀ, ``2·T·L·h·p`` for the intra-chunk products and ``4·T·h·p·n`` for
    the states and the inter-chunk term, ``T = b·s`` tokens, ``L =
    min(chunk, s)``."""
    T, L = b * s, min(chunk, s)
    return 2 * T * L * n + 2 * T * L * h * p + 4 * T * h * p * n


def ssd_scan_plain(x, dt, A, B, C, D, chunk: int,
                   init_state: Optional[torch.Tensor] = None):
    """The plain PyTorch version: ``models/mamba.py::ssd_plain``, the
    port's ``_ssd`` over a sequence padded to a multiple of the chunk."""
    from ..models.mamba import ssd_plain
    return ssd_plain(x, dt, A, B, C, D, chunk, init_state)


def _inner(t: torch.Tensor, dense: int) -> torch.Tensor:
    """``t`` with its last ``dense`` dimensions packed (its leading ones
    may keep any strides), copied only where they are not."""
    want = 1
    for d in range(t.dim() - 1, t.dim() - 1 - dense, -1):
        if t.shape[d] != 1 and t.stride(d) != want:
            return t.contiguous()
        want *= t.shape[d]
    return t


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None):
    """The chunked SSD of x ``(b, s, h, p)``, dt ``(b, s, h)`` (> 0), A
    ``(h,)`` (< 0), B and C ``(b, s, n)``, D ``(h,)`` and an optional
    initial state ``(b, h, p, n)`` in chunks of ``chunk`` rows (at most
    :data:`MAX_CHUNK`) → ``(y, final state)``.

    CUDA tensors go to the kernel: one call of its three launches
    (``ssd_scan.launches`` counts calls), with no gradient. x may be
    float32 or bfloat16 and keeps only its ``(h, p)`` packed, B and C only
    their ``n`` (views of a projection's output are read where they lie).
    dt, A, D and the state are read in float32, and B and C in their
    dtype where both share one of x's kinds, else in float32 (the plain
    version widens each to float32). CPU tensors go to
    :func:`ssd_scan_plain`. Raises for another dtype of x, a longer
    chunk, operands on two devices or shapes that disagree."""
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3:
        raise ValueError(f"ssd_scan takes x (b, s, h, p), dt (b, s, h) and "
                         f"B, C (b, s, n); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(B.shape) != (b, s, n)
            or tuple(C.shape) != (b, s, n) or tuple(A.shape) != (h,)
            or tuple(D.shape) != (h,) or (init_state is not None and tuple(
                init_state.shape) != (b, h, p, n))):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)} disagree")
    ops = [t for t in (dt, A, B, C, D, init_state) if t is not None]
    for t in ops:
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk, init_state)
    if not x.is_cuda:
        raise ValueError(f"ssd_scan runs on CUDA or the CPU, not {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan's kernel takes float32 or bfloat16 x, "
                         f"got {x.dtype}")
    L = min(chunk, s)
    c = -(-s // L) if L > 0 else 0
    if not 1 <= chunk or L > MAX_CHUNK:
        raise ValueError(f"ssd_scan's kernel takes a chunk of 1 to "
                         f"{MAX_CHUNK} rows, got {chunk}")
    if c > MAX_GRID or b > MAX_GRID or max(p * n, h * p) >= 1 << 31:
        raise ValueError(f"ssd_scan shape {tuple(x.shape)}, n {n}, chunk "
                         f"{chunk} exceeds the kernel's grid")
    with torch.cuda.device(x.device):
        y, state = _run(x, dt, A, B, C, D, L, init_state,
                        torch.cuda.current_stream(x.device).cuda_stream)
    with _COUNT_LOCK:
        ssd_scan.launches += 1
    return y, state


def _run(x, dt, A, B, C, D, L: int, init_state, stream: int):
    """One call of the kernel library on checked operands, chunk ``L``
    (at most the sequence), on ``stream``: the operands laid out as it
    reads them, the outputs and the scratch allocated on x's device."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, (state.zero_() if init_state is None
                   else state.copy_(init_state))
    if not (B.dtype == C.dtype and B.dtype in DTYPES):
        B, C = B.float(), C.float()
    x, B, C = _inner(x, 2), _inner(B, 1), _inner(C, 1)
    dt = _inner(dt.float(), 1)
    A, D = A.float().contiguous(), D.float().contiguous()
    init = None if init_state is None else init_state.float().contiguous()
    args = _Args(b, s, h, p, n, L, -(-s // L), int(x.dtype == torch.bfloat16),
                 int(B.dtype == torch.bfloat16), int(init is not None),
                 x.stride(0), x.stride(1), B.stride(0), B.stride(1),
                 C.stride(0), C.stride(1), dt.stride(0), dt.stride(1))
    scratch = torch.empty(scratch_elements(b, s, h, p, n, L),
                          dtype=torch.float32, device=x.device)
    err = entry(SOURCE, SYMBOL, 12)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), None if init is None else init.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    return y, state


ssd_scan.launches = 0
