"""Crossbar core of the port: plans, compiled traces, torch executors.

Public API:
    Crossbar               — stateful-logic interpreter (the host oracle)
    compile_program        — lower a Program to a packed executable trace
    execute                — batched executors on a torch device
    CrossbarPlan           — shared compile-then-execute plan base class
    MatvecPlan             — §II-A balanced full-precision matrix-vector
    BinaryMatvecPlan       — §II-B partition-tree binary matrix-vector
    ConvPlan               — §III-A/B input-parallel balanced convolution
    tiling                 — multi-crossbar scale-out (tiled matvec / conv)
    kernel_exec            — "kernels" backend: traces on repro_torch.kernels
"""
from .binary_matvec import (BinaryMatvecPlan, NaiveBinaryMatvecPlan,
                            matpim_binary_matvec)
from .compile import (CompiledProgram, FusedSchedule, Segment,
                      compile_program, compiled_from_state, compiled_state,
                      fuse_program)
from .conv import ConvPlan, matpim_conv2d
from .crossbar import Crossbar, SchedulingError, decode_uint, encode_uint
from .engine import (BACKENDS, EngineResult, execute, parse_backend,
                     resolve_device)
from .matvec import MatvecPlan, matpim_matvec
from .plan import CrossbarPlan
from .tiling import (TiledBinaryMatvec, TiledConv2d, TiledMatvec,
                     TiledResult, majority_sign, tiled_binary_matvec,
                     tiled_conv2d, tiled_matvec, tree_reduce)

__all__ = [
    "BACKENDS", "BinaryMatvecPlan", "CompiledProgram", "ConvPlan",
    "Crossbar", "CrossbarPlan", "EngineResult", "FusedSchedule",
    "MatvecPlan", "NaiveBinaryMatvecPlan", "SchedulingError", "Segment",
    "TiledBinaryMatvec", "TiledConv2d", "TiledMatvec", "TiledResult",
    "compile_program", "compiled_from_state", "compiled_state",
    "decode_uint", "encode_uint", "execute", "fuse_program",
    "majority_sign", "matpim_binary_matvec", "matpim_conv2d",
    "matpim_matvec", "parse_backend", "resolve_device",
    "tiled_binary_matvec", "tiled_conv2d", "tiled_matvec", "tree_reduce",
]
