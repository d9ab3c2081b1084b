"""MatPIM §II-A: balanced full-precision in-memory matrix-vector multiply.

``y = A @ x`` with A (m×n), x (n,), N-bit unsigned elements, inside one
crossbar. The asymmetry of the baseline (elements stored horizontally ⇒
n ≤ ~8 for N=32 in a 1024-wide array) is overcome by block decomposition:

    A = (A¹ … A^α),  x = (x¹ᵀ … x^αᵀ)ᵀ  ⇒  Ax = Σᵢ Aⁱ xⁱ

* block i occupies row band [i·m, (i+1)·m);
* all α inner-product phases run simultaneously (row parallelism is free
  across bands — the per-row MAC program is identical);
* the α partial vectors are summed by a logarithmic shift-up-and-add
  reduction (MatPIM Fig. 2(b)).

The baseline of [MultPIM, FloatPIM] is exactly the α=1 case.

Cycle formula and paper mapping: docs/ALGORITHMS.md §II-A.

The port of ``src/repro/core/matvec.py``: the program generator is the
reference's, line for line, so traces match it byte for byte; execution
takes the port's backends and an explicit ``device``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import arithmetic as A_
from .arithmetic import Program
from .crossbar import Crossbar, decode_uint, encode_uint
from .isa import InitOp, RowOp
from .layout import PartitionLayout, duplicate_band
from .plan import CrossbarPlan


class MatvecPlan(CrossbarPlan):
    """Layout + program for one (m, n, N, α) balanced matvec.

    >>> plan = MatvecPlan(4, 2, 4, alpha=1, rows=64, cols=256, parts=8)
    >>> A = np.array([[1, 2], [3, 4], [5, 6], [7, 8]])
    >>> y, cycles = plan.run(A, np.array([2, 3]), device="cpu")
    >>> [int(v) for v in y]          # exact mod 2^(2N)
    [8, 18, 28, 38]
    """

    def __init__(
        self,
        m: int,
        n: int,
        N: int,
        alpha: int = 1,
        rows: int = 1024,
        cols: int = 1024,
        parts: int = 32,
    ):
        assert n % alpha == 0, "alpha must divide n"
        assert alpha * m <= rows, f"alpha*m = {alpha*m} exceeds {rows} rows"
        assert m % (rows // parts) == 0 or alpha == 1, (
            "bands must be row-partition aligned for parallel duplication"
        )
        self.m, self.n, self.N, self.alpha = m, n, N, alpha
        self.rows, self.cols, self.parts = rows, cols, parts
        self.rp = rows // parts
        self.nb = n // alpha  # elements per block

        L = self.layout = PartitionLayout(cols, parts)
        # 2N-bit accumulator with wraparound (MultPIM-style arithmetic);
        # results are exact mod 2^(2N)
        self.W = 2 * N
        self.a_fields = [L.alloc(N) for _ in range(self.nb)]   # A row elements
        self.x_fields = [L.alloc(N) for _ in range(self.nb)]   # duplicated x
        self.prod = L.alloc(2 * N)
        self.acc = L.alloc(self.W)
        # the reduction's shifted-in operand reuses the (dead) product field
        self.acc2 = self.prod
        self.scratch = L.alloc(4)

        self.program = self._build()

    # -- program ------------------------------------------------------------

    def _build(self) -> Program:
        L, m, N = self.layout, self.m, self.N
        zero = L.zero_col(0)
        work = self.prod + self.acc + self.acc2 + self.scratch
        prog: Program = L.init_program(extra_cols=work)

        # Phase 1: duplicate x^i down band i (x^i preloaded in band row 0).
        # Bands are row-partition aligned ⇒ the α duplications interleave.
        x_cols = sorted(c for f in self.x_fields for c in f)
        dup = [
            duplicate_band(i * m, (i * m, (i + 1) * m), self.rp, cols=x_cols)
            for i in range(self.alpha)
        ]
        prog += A_.interleave(dup)

        # Phase 2: nb serial MACs, row-parallel across ALL bands at once.
        lane_cols = [p * L.cp + off for p in range(L.P) for off in range(2, 12)]
        for j in range(self.nb):
            # re-init carry-save lane state (bulk SET, 1 cycle)
            prog.append([InitOp(slice(None), lane_cols, 0)])
            prog += A_.emit_mult(
                self.a_fields[j], self.x_fields[j], self.prod,
                L.lanes, zero=zero, cp_size=L.cp,
            )
            prog += A_.emit_ripple_add(
                self.prod, self.acc, self.acc, tuple(self.scratch), zero
            )

        # Phase 3: logarithmic reduction over bands — MatPIM Fig. 2(b):
        # "shift half of them to the right and upwards, add in parallel".
        # Stride-doubled pairing (2k+1)s → (2k)s keeps every copy's row-
        # partition span inside a disjoint aligned block per pair.
        acc2_cols = sorted(self.acc2)
        s = 1
        while s < self.alpha:
            pairs = [((2 * k + 1) * s, 2 * k * s)
                     for k in range(self.alpha // (2 * s))]
            # (a) right-shift: acc -> acc2 (column ops, row-parallel over all
            #     bands at once; destination bands get overwritten in (b)).
            prog += A_.emit_copy_field(self.acc, self.acc2)
            # (b) up-shift: src band acc2 rows -> dst band acc2 rows,
            #     column-masked row copies; pairs run concurrently, rows
            #     serially.
            for r in range(m):
                cyc = [RowOp("OR2", (sb * m + r, sb * m + r), db * m + r, acc2_cols)
                       for sb, db in pairs]
                prog.append(cyc)
            # (c) add: acc += acc2 (row-parallel; extra rows harmless)
            prog += A_.emit_ripple_add(self.acc2, self.acc, self.acc,
                                       tuple(self.scratch), zero)
            s *= 2
        return prog

    # -- host entry points ----------------------------------------------------

    def kernel_spec(self):
        from .kernel_exec import matvec_spec
        return matvec_spec(self)

    def load_into(self, mem: np.ndarray, A: np.ndarray, x: np.ndarray) -> None:
        """Write operand bits into a (rows, cols) crossbar image."""
        m, n, N, nb = self.m, self.n, self.N, self.nb
        assert A.shape == (m, n) and x.shape == (n,)
        a_cols = np.array(self.a_fields).reshape(-1)   # [j][b] order
        x_cols = np.array(self.x_fields).reshape(-1)
        for i in range(self.alpha):
            blkA = A[:, i * nb : (i + 1) * nb]
            mem[i * m : (i + 1) * m, a_cols] = encode_uint(blkA, N).reshape(m, -1)
            xbits = encode_uint(x[i * nb : (i + 1) * nb], N)
            mem[i * m, x_cols] = xbits.reshape(-1)

    def decode_y(self, mem: np.ndarray) -> np.ndarray:
        return decode_uint(mem[: self.m][:, self.acc])

    def run(self, A: np.ndarray, x: np.ndarray, xbar: Optional[Crossbar] = None,
            backend: str = "torch", device="cuda") -> Tuple[np.ndarray, int]:
        out, cycles, _ = self.run_program(
            lambda mem: self.load_into(mem, A, x), xbar, backend, device)
        return self.decode_y(out), cycles


def matpim_matvec(A: np.ndarray, x: np.ndarray, N: int, alpha: int = 1,
                  backend: str = "torch", device="cuda",
                  **kw) -> Tuple[np.ndarray, int]:
    """Convenience wrapper: returns (y mod 2^W, cycle count)."""
    m, n = A.shape
    plan = MatvecPlan(m, n, N, alpha, **kw)
    return plan.run(A, x, backend=backend, device=device)
