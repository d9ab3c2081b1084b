"""Multi-crossbar tiling: scale binary matvec past a single 1024×1024 array.

The binary-matvec part of ``src/repro/core/tiling.py``. An arbitrary
``(M, K)`` ±1 matrix-vector product maps onto a grid of identical crossbar
tiles that all execute the *same* compiled program as one batch on the device
(``engine.execute`` packs them into machine-word bit-planes, or the
``kernels`` backend serves them in one launch), and the tile partials
reduce on the host with a binary tree.

Latency accounting: the B tiles are independent arrays running in lockstep,
so the in-memory latency of a tiled operation is the per-tile program length
(``result.cycles``); the host reduction is reported separately as
``result.reduce_depth`` levels of element-wise adds.

Binary matvec pads A and x with +1 — each padded column contributes exactly
one XNOR match, subtracted from the reduced popcount on the host. The
full-precision and conv wrappers arrive with their plans (ROADMAP Queue 1,
Slice B).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from .binary_matvec import BinaryMatvecPlan


@dataclasses.dataclass
class TiledResult:
    grid: Tuple[int, ...]      # tile grid shape
    n_tiles: int
    cycles: int                # per-tile program length (tiles run in lockstep)
    reduce_depth: int          # host tree-reduction levels (0 = none needed)
    backend: str               # engine-resolved label (e.g. "kernels")


def tree_reduce(parts: List[np.ndarray]) -> Tuple[np.ndarray, int]:
    """Pairwise binary-tree reduction; returns (sum, depth).

    >>> total, depth = tree_reduce([np.array([i]) for i in range(7)])
    >>> int(total[0]), depth
    (21, 3)
    """
    depth = 0
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
        depth += 1
    return parts[0], depth


def majority_sign(pop: np.ndarray, n: int) -> np.ndarray:
    """±1 majority from XNOR popcounts: sign(⟨a, x⟩) = sign(2·pop − n).

    Ties (dot exactly 0, even n) break to +1, matching the in-array plan's
    ``pop >= n/2`` threshold.

    >>> majority_sign(np.array([0, 2, 3, 4]), 4)   # dots -4, 0, 2, 4
    array([-1,  1,  1,  1])
    """
    return np.where(2 * pop - n >= 0, 1, -1)


def _execute_tiles(plan, n_tiles: int, load_tile, decode_tile,
                   backend: str, max_batch: Optional[int], faults=None,
                   device="cuda"):
    """Load/execute/decode tiles in bounded-size batches.

    Chunking only bounds host memory — every chunk runs the identical
    compiled program, so the reported in-array latency (one program length,
    all tiles in lockstep) is unchanged.
    """
    step = max_batch or 64
    results = [None] * n_tiles
    cycles = 0
    label = backend
    for s in range(0, n_tiles, step):
        e = min(n_tiles, s + step)
        mems = np.zeros((e - s, plan.rows, plan.cols), dtype=np.uint8)
        for b in range(s, e):
            load_tile(b, mems[b - s])
        res = plan.execute_batch(mems, backend=backend, device=device,
                                 faults=faults)
        cycles = res.cycles
        label = res.backend
        for b in range(s, e):
            results[b] = decode_tile(b, res.mem[b - s])
    return results, cycles, label


class TiledBinaryMatvec:
    """y = sign(<A[r], x>), A (M, K), x (K,) in {-1, +1}, over a tile grid."""

    def __init__(self, M: int, K: int, tile_m: Optional[int] = None,
                 tile_k: Optional[int] = None, rows: int = 1024,
                 cols: int = 1024, parts: int = 32):
        self.M, self.K = M, K
        self.tile_m = tile_m or min(M, rows)
        if tile_k is None:
            # widest n per tile: parts * npp with 2*npp + 6 <= cols/parts
            tile_k = parts * ((cols // parts - 6) // 2)
            tile_k = min(tile_k, math.ceil(K / parts) * parts)
        self.tile_k = tile_k
        assert self.tile_k % parts == 0
        self.gm = math.ceil(M / self.tile_m)
        self.gk = math.ceil(K / self.tile_k)
        self.plan = BinaryMatvecPlan(self.tile_m, self.tile_k,
                                     rows=rows, cols=cols, parts=parts)

    @property
    def n_tiles(self) -> int:
        return self.gm * self.gk

    def bind(self, A: np.ndarray, x: np.ndarray) -> Tuple:
        """Deferred-execution view of :meth:`run`.

        Returns ``(load_tile, decode_tile, finalize)``: the first two have
        the :func:`_execute_tiles` signatures, ``finalize(partials)`` returns
        ``(popcounts, reduce_depth)`` — the raw per-row XNOR popcounts
        (⟨A[r], x⟩ = 2·pop − K), tile padding already subtracted. This is the
        seam the serving layer uses to coalesce many requests' tiles into one
        engine batch.
        """
        M, K = self.M, self.K
        tm, tk, gm, gk = self.tile_m, self.tile_k, self.gm, self.gk
        assert A.shape == (M, K) and x.shape == (K,)
        # pad with +1/+1: every padded column XNOR-matches, adding exactly
        # (gk*tk - K) to each row's reduced popcount — subtracted below
        Ap = np.ones((gm * tm, gk * tk), dtype=np.int64)
        Ap[:M, :K] = A
        xp = np.ones(gk * tk, dtype=np.int64)
        xp[:K] = x
        n_pad = gk * tk - K
        plan = self.plan

        def load(b, mem):
            i, j = divmod(b, gk)
            plan.load_into(mem, Ap[i * tm : (i + 1) * tm,
                                   j * tk : (j + 1) * tk],
                           xp[j * tk : (j + 1) * tk])

        def decode(b, mem):
            return plan.decode_popcount(mem).astype(np.int64)

        def finalize(partials):
            pop = np.empty((gm, tm), dtype=np.int64)
            depth = 0
            for i in range(gm):
                total, depth = tree_reduce(partials[i * gk : (i + 1) * gk])
                pop[i] = total - n_pad
            return pop.reshape(-1)[:M], depth

        return load, decode, finalize

    def run(self, A: np.ndarray, x: np.ndarray, backend: str = "torch",
            max_batch: Optional[int] = None, faults=None,
            device="cuda") -> Tuple[np.ndarray, TiledResult]:
        load, decode, finalize = self.bind(A, x)
        partials, cycles, label = _execute_tiles(
            self.plan, self.n_tiles, load, decode, backend, max_batch,
            faults, device)
        pop_flat, depth = finalize(partials)
        y = majority_sign(pop_flat, self.K)
        self.last_popcounts = pop_flat  # XNOR matches per row (dot = 2*pop - K)
        return y, TiledResult((self.gm, self.gk), self.n_tiles, cycles,
                              depth, label)


def tiled_binary_matvec(A: np.ndarray, x: np.ndarray, backend: str = "torch",
                        max_batch: Optional[int] = None, faults=None,
                        device="cuda", **kw):
    """One-shot tiled ±1 matvec (see :class:`TiledBinaryMatvec`); ``kw``
    goes to its constructor.

    >>> y, info = tiled_binary_matvec(np.ones((4, 64), dtype=int),
    ...                               np.ones(64, dtype=int), device="cpu",
    ...                               tile_k=32, rows=64, cols=256, parts=8)
    >>> [int(v) for v in y], info.n_tiles, info.reduce_depth
    ([1, 1, 1, 1], 2, 1)
    """
    M, K = A.shape
    t = TiledBinaryMatvec(M, K, **kw)
    return t.run(A, x, backend=backend, max_batch=max_batch, faults=faults,
                 device=device)
