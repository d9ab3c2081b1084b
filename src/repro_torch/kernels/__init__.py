"""Hand-written Hopper kernels of the port, and how they are built.

Each is CUDA C++ for sm_90a in place of a Pallas kernel of
``src/repro/kernels/``:

    binary_matmul       — XNOR-popcount GEMM (MatPIM §II-B)
                          (``binary_matmul.py``, ``csrc/binary_matmul.cu``)
    splitk_matvec       — f32-accumulate GEMV (MatPIM §II-A block/reduce)
                          (``splitk_matvec.py``, ``csrc/splitk_matvec.cu``)
    conv2d_shift        — shift-and-add conv, register strips of outputs
                          over CTA tiles chosen for the card (MatPIM §III-A)
    conv2d_shift_tiled  — the same kernel under the reference's bh×bw tile
                          contract
    binary_conv2d       — channel-packed XNOR conv (MatPIM §III-C), lane
                          groups per output over tiles chosen for the card
                          (all three ``conv2d_shift.py``,
                          ``csrc/conv2d_shift.cu``)

and two that replace no Pallas kernel, on the model stack's path:

    decode_attention    — split-K flash decoding of one query row against
                          a KV cache's valid rows, read once in 16-byte
                          loads (``decode_attention.py``,
                          ``csrc/decode_attention.cu``)
    ssd_scan            — Mamba-2's chunked SSD scan of a prefill or
                          forward in three launches, no ``(c, h, l, l)``
                          intermediate in device memory (``ssd_scan.py``,
                          ``csrc/ssd_scan.cu``)

The wrappers share one host path (:func:`launch`): the checks and values
that depend only on shapes and dtypes are computed once per signature and
cached (:class:`Signature`, with the launch arguments packed in a
``ctypes.Structure``), so a call on CUDA tensors makes a few device and
layout checks, one ``new_empty``, one stream read and one ctypes call with
the data pointers (two operands and the output; ``decode_attention``'s
four operands, output and scratch), the packed arguments' address and the
stream. ``ssd_scan``, with two outputs and strided operands, calls
:func:`entry` from its own wrapper.
:func:`staged_rows` is the launch plan shared by the two kernels that stage
whole short rows in shared memory (``splitk_matvec``, ``binary_matmul``).

``ops.py`` holds the public wrappers (``matvec``, ``conv2d``,
``conv2d_binary``, ``binary_dense``, ``as_packed_words``); ``ref.py`` the
plain oracles. Both are exported here. Each kernel function lives in the
module of its own name (``kernels.splitk_matvec.splitk_matvec``) and is not
re-exported, so ``repro_torch.kernels.<name>`` stays the module.

Each kernel's CUDA source lives in ``src/repro_torch/csrc/``. At first use
:func:`load_library` compiles it with ``nvcc`` into a shared library with a
plain C interface under ``build/repro_torch/`` at the repository root and
loads it with ``ctypes``. The library's file name carries a hash of the
source and the flags, so a stale build is never loaded. A source may take
``-D`` flags that pick one variant of its templates
(``csrc/decode_attention.cu``); each variant is a library of its own,
built at its first launch. Nothing is built or
loaded at import time: the CPU tests import every module on machines that
have no ``nvcc``. Each kernel module keeps a plain PyTorch version of the
same function beside its wrapper (``ref.py`` holds the reference oracles).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) — the CUDA kernels build at first use")
    return found


def library_path(source: str, defines: tuple = ()) -> Path:
    """Where ``csrc/<source>`` builds to: the name carries a hash of the
    source bytes, the headers of ``csrc/``, the flags and ``defines`` (the
    ``-D`` flags of one variant of the source)."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str, defines: tuple = ()) -> str:
    """Compile ``csrc/<source>`` (with the ``-D`` flags ``defines``) unless
    its hashed library exists; returns the compiler's log (``-Xptxas -v``
    register and spill report), empty when nothing was built. Raises with
    the log when ``nvcc`` fails."""
    so = library_path(source, defines)
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(
        f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
         str(CSRC / source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)          # atomic: a concurrent build never sees half
    return proc.stdout + proc.stderr


@functools.cache
def load_library(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` (its variant
    ``defines``); one handle per process."""
    build(source, defines)
    return ctypes.CDLL(str(library_path(source, defines)))


@functools.cache
def entry(source: str, symbol: str, n: int = 5, defines: tuple = ()):
    """A kernel's C entry point ``symbol`` in ``csrc/<source>`` (its
    variant ``defines``), built and loaded at first use: ``n`` arguments,
    all ``c_void_p``: ``(in0, in1, out, args, stream)``, or more operands
    after ``in1`` and a scratch after ``out`` (``args`` the packed launch
    arguments' address)."""
    fn = getattr(load_library(source, defines), symbol)
    fn.argtypes = [ctypes.c_void_p] * n
    fn.restype = ctypes.c_int
    return fn


class Signature(NamedTuple):
    """Everything a call needs that depends only on the operands' shapes
    and dtypes, computed once per signature by each kernel module."""
    out_shape: tuple
    out_dtype: torch.dtype
    n_out: int
    refusal: str | None       # why the kernel cannot take it (CUDA only)
    args: ctypes.Structure | None   # None when there is nothing to launch
    args_addr: int
    scratch: int | None = None  # float32 scratch elements a launch
                              # takes (0: the entry's slot is null)
    defines: tuple = ()       # the source's variant a launch runs


_COUNT_LOCK = threading.Lock()


def launch(wrapper, sig: Signature, a: torch.Tensor, b: torch.Tensor,
           source: str, symbol: str, *rest: torch.Tensor):
    """The wrappers' shared path after the cached signature: ``None`` for
    CPU operands (the caller runs its plain version); for CUDA operands the
    device and layout checks, then one launch of ``symbol`` on the current
    stream, counted on ``wrapper.launches``. Operands past ``b`` (``rest``)
    follow it in the call; a signature with a ``scratch`` passes a float32
    scratch of that many elements after the output (a null pointer for
    0); a signature's ``defines`` picks the variant of the source built
    for it. Raises for operands on two devices, on another device type, not
    contiguous, or refused by the kernel (``sig.refusal``), and when CUDA
    refuses the launch."""
    dev = a.get_device()
    if not (a.is_cuda and b.is_cuda and b.get_device() == dev) or (
            rest and not all(t.is_cuda and t.get_device() == dev
                             for t in rest)):
        for t in (b, *rest):
            if a.device != t.device:
                raise ValueError(f"operands on {a.device} and {t.device}")
        if a.device.type != "cpu":
            raise ValueError(f"{wrapper.__name__} runs on CUDA or the CPU, "
                             f"not {a.device}")
        return None
    if not (a.is_contiguous() and b.is_contiguous()
            and all(t.is_contiguous() for t in rest)):
        raise ValueError(f"{wrapper.__name__} takes contiguous operands")
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):    # launch on the operands' card
            return launch(wrapper, sig, a, b, source, symbol, *rest)
    if sig.refusal:
        raise ValueError(sig.refusal)
    # the output on a's card, the current one (just checked), and its stream
    # by index: the cheapest public forms (chip_smoke.py's conv_host and
    # matvec_host records time the steps)
    out = a.new_empty(sig.out_shape, dtype=sig.out_dtype)
    if sig.n_out:
        ptrs = [a.data_ptr(), b.data_ptr(), *[t.data_ptr() for t in rest],
                out.data_ptr()]
        if sig.scratch is not None:   # held until launched; freed at
            scratch = a.new_empty(        # return, reused in stream order
                sig.scratch, dtype=torch.float32) if sig.scratch else None
            ptrs.append(0 if scratch is None else scratch.data_ptr())
        err = entry(source, symbol, len(ptrs) + 2, sig.defines)(
            *ptrs, sig.args_addr, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA "
                               f"error {err}")
        with _COUNT_LOCK:           # device-slot threads launch at once
            wrapper.launches += 1
    return out


# The row-staging plan's constants, for the H100 SXM.
MIN_CTAS = 132            # one CTA per SM
MAX_ROWS = 128            # rows a CTA stages
SMEM_BYTES = 48 * 1024    # dynamic shared memory a block gets with no opt-in


class RowPlan(NamedTuple):
    """One launch of a kernel that stages whole rows: ``rows`` consecutive
    rows of one batch entry per CTA, ``lanes`` threads reducing each row;
    the rows' span starts in shared memory at offset 0 (plus the span's
    misalignment), the vector at ``x_off`` bytes."""
    rows: int
    threads: int
    lanes: int
    rot: int                  # each row's walk starts at its own column
    grid: tuple[int, int]     # (CTAs per batch entry, batch entries)
    smem: int
    x_off: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def span_bytes(rows: int, K: int, itemsize: int) -> int:
    """Shared bytes for ``rows`` rows of ``K`` elements staged as one span:
    the span's misalignment (up to 15 bytes) ahead of it, whole 16 bytes."""
    return _round_up(16 - itemsize + rows * K * itemsize, 16)


def staged_rows(B: int, M: int, K: int, itemsize: int,
                x_bytes: int) -> RowPlan | None:
    """The row-staging plan over ``B`` batch entries of ``M`` rows of ``K``
    elements of ``itemsize`` bytes, with an ``x_bytes`` vector staged beside
    them; ``None`` when one row and the vector do not fit ``SMEM_BYTES``.

    Rows per CTA: the most, a power of two up to ``MAX_ROWS``, whose span
    and vector fit ``SMEM_BYTES`` and that still give ``min(MIN_CTAS,
    B·M)`` CTAs, so a launch of at least 132 rows fills every SM. A CTA has
    ``max(32, rows)`` threads: one per row, or a group of ``lanes`` (a power
    of two) per row when the CTA has fewer than 32 rows. With an even ``K``
    a row's lanes start at its own column (``rot``), so the threads of a
    warp read distinct banks; an odd row stride does that by itself."""
    x_off = span_bytes(1, K, itemsize)
    if x_off + x_bytes > SMEM_BYTES:
        return None
    want = min(MIN_CTAS, B * M)
    R = MAX_ROWS
    while R > 1 and (span_bytes(R, K, itemsize) + x_bytes > SMEM_BYTES
                     or -(-M // R) * B < want):
        R //= 2
    threads = max(32, R)
    x_off = span_bytes(R, K, itemsize)
    return RowPlan(rows=R, threads=threads, lanes=threads // R,
                   rot=int(K > 0 and K % 2 == 0), grid=(-(-M // R), B),
                   smem=x_off + x_bytes, x_off=x_off)


# after load_library: ops and ref import the kernel modules, which import it
from . import ops, ref  # noqa: E402

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "RowPlan", "Signature",
           "build", "entry", "launch", "library_path", "load_library", "ops",
           "ref", "span_bytes", "staged_rows"]
