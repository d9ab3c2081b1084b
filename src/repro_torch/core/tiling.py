"""Multi-crossbar tiling: scale matvec and conv past a single 1024×1024
array.

The port of ``src/repro/core/tiling.py``. An arbitrary ``(M, K)``
matrix-vector product or a large 2D convolution maps onto a grid of
identical crossbar tiles that all execute the *same* compiled program as one
batch on the device (``engine.execute`` packs them into machine-word
bit-planes, or the ``kernels`` backend serves them in one launch), and the
tile partials reduce on the host with a binary tree.

Latency accounting: the B tiles are independent arrays running in lockstep,
so the in-memory latency of a tiled operation is the per-tile program length
(``result.cycles``); the host reduction is reported separately as
``result.reduce_depth`` levels of element-wise adds.

Padding conventions keep tile programs identical across the grid:

* full-precision matvec/conv pad with zeros (adds 0 mod 2^W / contributes 0);
* binary matvec pads A and x with +1 — each padded column contributes exactly
  one XNOR match, subtracted from the reduced popcount on the host;
* binary conv pads the input with +1; affected outputs fall outside the
  cropped valid region.

Every wrapper prices one tile with ``energy()`` (the static trace energy of
:mod:`repro_torch.device.energy`; the grid total is ``n_tiles`` times it),
the hook the application pipelines charge each stage with.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from .binary_conv import BinaryConvPlan
from .binary_matvec import BinaryMatvecPlan
from .conv import ConvPlan
from .matvec import MatvecPlan


@dataclasses.dataclass
class TiledResult:
    grid: Tuple[int, ...]      # tile grid shape
    n_tiles: int
    cycles: int                # per-tile program length (tiles run in lockstep)
    reduce_depth: int          # host tree-reduction levels (0 = none needed)
    backend: str               # engine-resolved label (e.g. "kernels")


class _TiledEnergyMixin:
    """Shared device-model hooks for the matvec wrappers.

    The grid runs ONE compiled program on every tile, so the per-tile trace
    energy is a single static pricing pass and the grid total is a multiply
    — the hook :mod:`repro_torch.apps.pipeline` uses to charge each stage.
    """

    @property
    def n_tiles(self) -> int:
        return self.gm * self.gk

    def energy(self, profile=None):
        """Per-tile :class:`~repro_torch.device.energy.EnergyReport` (grid
        total = ``report.total_fj * self.n_tiles``)."""
        return self.plan.energy(profile)


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
                   rng=None, device="cuda", mesh=None):
    """Load/execute/decode tiles in bounded-size batches.

    Chunking only bounds host memory — every chunk runs the identical
    compiled program, so the reported in-array latency (one program length,
    all tiles in lockstep) is unchanged. With ``faults``, every tile draws
    an independent device-fault realization from ONE stream shared across
    the chunks (``rng``: ``None`` / seed / Generator), as in the reference.

    With a ``mesh`` (explicit or ambient via
    ``distributed.sharding.use_mesh``), fault-free batches hand the whole
    tile axis to the engine in larger host chunks so
    ``distributed.mesh_exec`` can shard it across device slots; results
    stay bit-identical to the single-device loop.
    """
    if faults is not None:
        rng = np.random.default_rng(rng)  # one stream across all chunks
    step = max_batch or (min(n_tiles, 256) if mesh is not None
                         and faults is None else 64)
    results = [None] * n_tiles
    cycles = 0
    label = backend
    for s in range(0, n_tiles, step):
        e = min(n_tiles, s + step)
        mems = np.zeros((e - s, plan.rows, plan.cols), dtype=np.uint8)
        for b in range(s, e):
            load_tile(b, mems[b - s])
        res = plan.execute_batch(mems, backend=backend, device=device,
                                 faults=faults, rng=rng, mesh=mesh)
        cycles = res.cycles
        label = res.backend
        for b in range(s, e):
            results[b] = decode_tile(b, res.mem[b - s])
    return results, cycles, label


def max_matvec_block(N: int, cols: int = 1024, parts: int = 32) -> int:
    """Largest per-tile n (α=1 elements) that fits the column budget.

    >>> max_matvec_block(8), max_matvec_block(32)
    (39, 8)
    """
    cp = cols // parts
    budget = (cp - 12 + 1) * parts          # data offsets incl. offset 1
    overhead = 4 * N + 4                    # prod + acc (+aliased acc2) + scratch
    return max(1, (budget - overhead) // (2 * N))


def _run_kw(kw):
    """Split run-time kwargs (backend/max_batch/faults/rng/device/mesh)
    from plan kwargs."""
    return {k: kw.pop(k)
            for k in ("backend", "max_batch", "faults", "rng", "device",
                      "mesh")
            if k in kw}


# ---------------------------------------------------------------------------
# Full-precision matvec:  y = A @ x  mod 2^(2N),  A (M, K) N-bit unsigned
# ---------------------------------------------------------------------------


class TiledMatvec(_TiledEnergyMixin):
    """y = A @ x mod 2^(2N), A (M, K) and x (K,) N-bit unsigned, over a
    tile grid of ``MatvecPlan(tile_m, tile_k, N)`` (α = 1)."""

    def __init__(self, M: int, K: int, N: int, tile_m: Optional[int] = None,
                 tile_k: Optional[int] = None, rows: int = 1024,
                 cols: int = 1024, parts: int = 32):
        self.M, self.K, self.N = M, K, N
        self.tile_m = tile_m or min(M, rows)
        self.tile_k = tile_k or min(K, max_matvec_block(N, cols, parts))
        self.gm = math.ceil(M / self.tile_m)
        self.gk = math.ceil(K / self.tile_k)
        self.plan = MatvecPlan(self.tile_m, self.tile_k, N, alpha=1,
                               rows=rows, cols=cols, parts=parts)

    def bind(self, A: np.ndarray, x: np.ndarray) -> Tuple:
        """Deferred-execution view of :meth:`run`.

        Returns ``(load_tile, decode_tile, finalize)``: the first two have
        the :func:`_execute_tiles` signatures, ``finalize(partials)`` tree-
        reduces the decoded tile partials into ``(y, reduce_depth)``. This
        is the seam the serving layer uses to coalesce many requests' tiles
        into one engine batch.
        """
        M, K = self.M, self.K
        tm, tk, gm, gk = self.tile_m, self.tile_k, self.gm, self.gk
        assert A.shape == (M, K) and x.shape == (K,)
        Ap = np.zeros((gm * tm, gk * tk), dtype=np.int64)
        Ap[:M, :K] = A
        xp = np.zeros(gk * tk, dtype=np.int64)
        xp[:K] = x
        plan = self.plan

        def load(b, mem):
            i, j = divmod(b, gk)
            plan.load_into(mem, Ap[i * tm : (i + 1) * tm,
                                   j * tk : (j + 1) * tk],
                           xp[j * tk : (j + 1) * tk])

        def decode(b, mem):
            return plan.decode_y(mem).astype(object)

        def finalize(partials):
            W = plan.W  # accumulator width: results exact mod 2^(2N)
            y = np.empty(gm * tm, dtype=object)
            depth = 0
            for i in range(gm):
                total, depth = tree_reduce(partials[i * gk : (i + 1) * gk])
                y[i * tm : (i + 1) * tm] = total % (1 << W)
            return y[:M], depth

        return load, decode, finalize

    def run(self, A: np.ndarray, x: np.ndarray, backend: str = "torch",
            max_batch: Optional[int] = None, faults=None, rng=None,
            device="cuda", mesh=None) -> Tuple[np.ndarray, TiledResult]:
        load, decode, finalize = self.bind(A, x)
        partials, cycles, label = _execute_tiles(
            self.plan, self.n_tiles, load, decode, backend, max_batch,
            faults, rng, device, mesh)
        y, depth = finalize(partials)
        return y, TiledResult((self.gm, self.gk), self.n_tiles, cycles,
                              depth, label)


def tiled_matvec(A: np.ndarray, x: np.ndarray, N: int, **kw):
    """One-shot tiled full-precision matvec (see :class:`TiledMatvec`);
    run-time kwargs (``backend``, ``max_batch``, ``faults``, ``rng``,
    ``device``) go to :meth:`TiledMatvec.run`, the rest to its
    constructor.

    >>> y, info = tiled_matvec(np.full((4, 6), 3), np.arange(6), 4,
    ...                        tile_k=4, rows=64, cols=256, parts=8,
    ...                        device="cpu")
    >>> [int(v) for v in y], info.grid, info.reduce_depth
    ([45, 45, 45, 45], (1, 2), 1)
    """
    M, K = A.shape
    run_kw = _run_kw(kw)
    t = TiledMatvec(M, K, N, **kw)
    return t.run(A, x, **run_kw)


# ---------------------------------------------------------------------------
# Binary matvec:  y = sign(<A[r], x>),  A (M, K), x (K,) in {-1, +1}
# ---------------------------------------------------------------------------


class TiledBinaryMatvec(_TiledEnergyMixin):
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
            max_batch: Optional[int] = None, faults=None, rng=None,
            device="cuda", mesh=None) -> Tuple[np.ndarray, TiledResult]:
        load, decode, finalize = self.bind(A, x)
        partials, cycles, label = _execute_tiles(
            self.plan, self.n_tiles, load, decode, backend, max_batch,
            faults, rng, device, mesh)
        pop_flat, depth = finalize(partials)
        y = majority_sign(pop_flat, self.K)
        self.last_popcounts = pop_flat  # XNOR matches per row (dot = 2*pop - K)
        return y, TiledResult((self.gm, self.gk), self.n_tiles, cycles,
                              depth, label)

    def popcounts(self, A: np.ndarray, x: np.ndarray, backend: str = "torch",
                  device="cuda") -> np.ndarray:
        """Per-row XNOR popcounts (so ⟨A[r], x⟩ = 2·pop[r] − K)."""
        self.run(A, x, backend=backend, device=device)
        return self.last_popcounts

    def popcounts_many(self, A: np.ndarray, X: np.ndarray,
                       backend: str = "torch",
                       max_batch: Optional[int] = None, faults=None,
                       rng=None, device="cuda", mesh=None) -> np.ndarray:
        """Popcounts of one A against J vectors: X is (J, K), returns (J, M).

        All J · gm · gk (vector, tile) pairs execute as engine batches of
        64 tiles (``max_batch``), vector-major — one launch per batch on
        the ``kernels`` backend; with ``faults`` every (vector, tile) pair
        draws an independent realization from one shared stream.
        """
        M, K = self.M, self.K
        tm, tk, gm, gk = self.tile_m, self.tile_k, self.gm, self.gk
        J = X.shape[0]
        assert A.shape == (M, K) and X.shape == (J, K)
        Ap = np.ones((gm * tm, gk * tk), dtype=np.int64)
        Ap[:M, :K] = A
        Xp = np.ones((J, gk * tk), dtype=np.int64)
        Xp[:, :K] = X
        n_pad = gk * tk - K
        plan = self.plan

        def load(b, mem):
            j, rest = divmod(b, gm * gk)
            i, kk = divmod(rest, gk)
            plan.load_into(mem, Ap[i * tm : (i + 1) * tm,
                                   kk * tk : (kk + 1) * tk],
                           Xp[j, kk * tk : (kk + 1) * tk])

        partials, _, _ = _execute_tiles(
            plan, J * gm * gk, load,
            lambda b, mem: plan.decode_popcount(mem).astype(np.int64),
            backend, max_batch, faults, rng, device, mesh)

        pop = np.empty((J, gm * tm), dtype=np.int64)
        for j in range(J):
            for i in range(gm):
                s = (j * gm + i) * gk
                total, _ = tree_reduce(partials[s : s + gk])
                pop[j, i * tm : (i + 1) * tm] = total - n_pad
        return pop[:, :M]


def tiled_binary_matvec(A: np.ndarray, x: np.ndarray, backend: str = "torch",
                        max_batch: Optional[int] = None, faults=None,
                        rng=None, device="cuda", mesh=None, **kw):
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
                 rng=rng, device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# Convolutions: tile the image with (k-1)-halos; outputs concatenate, so the
# host reduction degenerates to assembly (reduce_depth 0)
# ---------------------------------------------------------------------------


class TiledConv2d:
    """Valid conv of an (H, Wd) image with a k×k kernel over a grid of
    tiles whose inputs overlap by k−1 (halo): full precision (mod 2^N) on
    ``ConvPlan(tile_m, tile_n, k, N)``, or with ``binary=True`` the ±1 sign
    map on ``BinaryConvPlan(tile_m, tile_n, k)``."""

    def __init__(self, H: int, Wd: int, k: int, N: int, tile_m: int = 64,
                 tile_n: int = 8, binary: bool = False, rows: int = 1024,
                 cols: int = 1024, parts: int = 32, **plan_kw):
        assert tile_m > k - 1 and tile_n > k - 1
        self.H, self.Wd, self.k, self.N = H, Wd, k, N
        self.binary = binary
        self.tile_m, self.tile_n = tile_m, tile_n
        self.oh, self.ow = H - k + 1, Wd - k + 1            # valid output
        self.th_out = tile_m - k + 1                        # out rows per tile
        self.tw_out = tile_n - k + 1
        self.gh = math.ceil(self.oh / self.th_out)
        self.gw = math.ceil(self.ow / self.tw_out)
        if binary:
            self.plan = BinaryConvPlan(tile_m, tile_n, k, rows=rows,
                                       cols=cols, parts=parts)
        else:
            self.plan = ConvPlan(tile_m, tile_n, k, N, rows=rows, cols=cols,
                                 parts=parts, **plan_kw)

    @property
    def n_tiles(self) -> int:
        return self.gh * self.gw

    def energy(self, profile=None, K: Optional[np.ndarray] = None):
        """Per-tile trace energy; conv programs specialize on the kernel, so
        pass ``K`` (or run once) before pricing."""
        if K is not None:
            self.plan.ensure_program(K)
        return self.plan.energy(profile)

    def bind(self, A: np.ndarray, Kk: np.ndarray) -> Tuple:
        """Deferred-execution view of :meth:`run` (see
        :meth:`TiledMatvec.bind`); (re)specializes the plan's program on
        ``Kk`` up front. ``finalize(tiles)`` assembles the halo-tiled
        outputs and returns ``(out, 0)`` (conv has no host reduction)."""
        H, Wd, k = self.H, self.Wd, self.k
        assert A.shape == (H, Wd) and Kk.shape == (k, k)
        Hp = self.gh * self.th_out + k - 1
        Wp = self.gw * self.tw_out + k - 1
        pad_val = 1 if self.binary else 0
        Ap = np.full((Hp, Wp), pad_val, dtype=np.int64)
        Ap[:H, :Wd] = A

        plan = self.plan
        plan.ensure_program(Kk)

        def load(b, mem):
            i, j = divmod(b, self.gw)
            r0, c0 = i * self.th_out, j * self.tw_out
            plan.load_into(mem, Ap[r0 : r0 + self.tile_m,
                                   c0 : c0 + self.tile_n], Kk)

        def decode(b, mem):
            return plan.decode_out(mem)

        def finalize(tiles):
            dtype = np.int64 if self.binary else object
            out = np.zeros((self.gh * self.th_out, self.gw * self.tw_out),
                           dtype=dtype)
            for i in range(self.gh):
                for j in range(self.gw):
                    out[i * self.th_out : (i + 1) * self.th_out,
                        j * self.tw_out : (j + 1) * self.tw_out] = \
                        tiles[i * self.gw + j]
            return out[: self.oh, : self.ow], 0

        return load, decode, finalize

    def run(self, A: np.ndarray, Kk: np.ndarray, backend: str = "torch",
            max_batch: Optional[int] = None, faults=None, rng=None,
            device="cuda", mesh=None) -> Tuple[np.ndarray, TiledResult]:
        load, decode, finalize = self.bind(A, Kk)
        tiles, cycles, label = _execute_tiles(
            self.plan, self.n_tiles, load, decode, backend, max_batch,
            faults, rng, device, mesh)
        out, _ = finalize(tiles)
        return out, TiledResult(
            (self.gh, self.gw), self.n_tiles, cycles, 0, label)


def tiled_conv2d(A: np.ndarray, Kk: np.ndarray, N: int, **kw):
    """One-shot tiled conv (see :class:`TiledConv2d`); run-time kwargs go to
    :meth:`TiledConv2d.run`, the rest to its constructor.

    >>> out, info = tiled_conv2d(np.arange(30).reshape(5, 6),
    ...                          np.array([[1, 0], [0, 1]]), 8, tile_m=3,
    ...                          tile_n=3, rows=64, cols=256, parts=8,
    ...                          device="cpu")
    >>> [int(v) for v in out[0]], info.grid
    ([7, 9, 11, 13, 15], (2, 3))
    """
    H, Wd = A.shape
    run_kw = _run_kw(kw)
    t = TiledConv2d(H, Wd, Kk.shape[0], N, **kw)
    return t.run(A, Kk, **run_kw)


def tiled_binary_conv2d(A: np.ndarray, Kk: np.ndarray, **kw):
    """One-shot tiled ±1 conv (``TiledConv2d(binary=True)``, ``tile_n`` 64
    unless given); run-time kwargs go to :meth:`TiledConv2d.run`.

    >>> out, info = tiled_binary_conv2d(np.ones((6, 40), dtype=int),
    ...                                 -np.ones((3, 3), dtype=int),
    ...                                 tile_m=4, tile_n=32, rows=64,
    ...                                 cols=256, parts=8, device="cpu")
    >>> out.shape, sorted(set(out.ravel().tolist())), info.grid
    ((4, 38), [-1], (2, 2))
    """
    H, Wd = A.shape
    run_kw = _run_kw(kw)
    kw.setdefault("tile_n", 64)
    t = TiledConv2d(H, Wd, Kk.shape[0], 1, binary=True, **kw)
    return t.run(A, Kk, **run_kw)
