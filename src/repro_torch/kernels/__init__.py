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
    binary_conv2d       — channel-packed XNOR conv (MatPIM §III-C)
                          (all three ``conv2d_shift.py``,
                          ``csrc/conv2d_shift.cu``)

``ops.py`` holds the public wrappers (``matvec``, ``conv2d``,
``conv2d_binary``, ``binary_dense``, ``as_packed_words``); ``ref.py`` the
plain oracles. Both are exported here. Each kernel function lives in the
module of its own name (``kernels.splitk_matvec.splitk_matvec``) and is not
re-exported, so ``repro_torch.kernels.<name>`` stays the module.

Each kernel's CUDA source lives in ``src/repro_torch/csrc/``. At first use
:func:`load_library` compiles it with ``nvcc`` into a shared library with a
plain C interface under ``build/repro_torch/`` at the repository root and
loads it with ``ctypes``. The library's file name carries a hash of the
source and the flags, so a stale build is never loaded. Nothing is built or
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
from pathlib import Path

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


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: the name carries a hash of the
    source bytes and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its hashed library exists; returns
    the compiler's log (``-Xptxas -v`` register and spill report), empty
    when nothing was built. Raises with the log when ``nvcc`` fails."""
    so = library_path(source)
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)          # atomic: a concurrent build never sees half
    return proc.stdout + proc.stderr


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; one handle per process."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))


# after load_library: ops and ref import the kernel modules, which import it
from . import ops, ref  # noqa: E402

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "library_path",
           "load_library", "ops", "ref"]
