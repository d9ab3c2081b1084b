"""MatPIM §II-B: fast binary matrix-vector multiplication.

Elements of A (m×n) and x (n,) are ±1, encoded as bits (0 ↔ −1, 1 ↔ +1).
Row r computes ``popcount(XNOR(A[r], x))`` and the quantized (majority)
output ``y[r] = [popcount ≥ n/2]``  (since ⟨A[r],x⟩ = 2·popcount − n).

The two MatPIM accelerations over the naive counter method:

1. **tree popcount** — pairwise adds with logarithmically growing width
   instead of a full-width counter increment per element;
2. **partition parallelism** — each of the P column partitions popcounts its
   n/P resident product bits serially but *concurrently* with all others,
   followed by a log₂(P)-level inter-partition adder-tree reduction
   (MatPIM Fig. 2(c)).

Column management: every partition runs the *same* program at the same
per-partition offsets (offset 0 = const-0, 1 = const-1, 2.. = data), so one
emitted step is P concurrent gates. Dead columns (consumed inputs) are
recycled through bulk re-init cycles — in-memory register allocation.

Cycle formula and paper mapping: docs/ALGORITHMS.md §II-B.

The port of ``src/repro/core/binary_matvec.py``: the program generator is
the reference's, line for line, so traces match it byte for byte; execution
takes the port's backends and an explicit ``device``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from . import arithmetic as A_
from .arithmetic import Program
from .crossbar import Crossbar, decode_uint
from .isa import ColOp, InitOp
from .layout import duplicate_band
from .plan import CrossbarPlan


class _OffsetAlloc:
    """Offset-space allocator with dead-column recycling via bulk re-init."""

    def __init__(self, offsets: List[int]):
        self.free = list(offsets)
        self.dead: List[int] = []
        self.reinit_cycles = 0

    def take(self, n: int, prog: Program, P: int, cp: int) -> List[int]:
        got: List[int] = []
        while len(got) < n:
            if not self.free:
                if not self.dead:
                    raise RuntimeError("partition column budget exhausted")
                cols = sorted(p * cp + off for p in range(P) for off in self.dead)
                prog.append([InitOp(slice(None), cols, 0)])
                self.reinit_cycles += 1
                self.free, self.dead = self.dead, []
            got.append(self.free.pop(0))
        return got

    def kill(self, offs: List[int]) -> None:
        self.dead.extend(offs)


class BinaryMatvecPlan(CrossbarPlan):
    """Partition-tree XNOR-popcount matvec over ±1 operands.

    >>> plan = BinaryMatvecPlan(2, 8, rows=16, cols=64, parts=2)
    >>> A = np.array([[1] * 8, [-1] * 8])
    >>> y, pop, cycles = plan.run(A, np.ones(8, dtype=int), device="cpu")
    >>> [int(v) for v in y], [int(p) for p in pop]
    ([1, -1], [8, 0])
    """

    def __init__(self, m: int, n: int, rows: int = 1024, cols: int = 1024,
                 parts: int = 32):
        assert m <= rows
        self.m, self.n = m, n
        self.rows, self.cols, self.parts = rows, cols, parts
        self.rp = rows // parts
        self.cp = cols // parts
        P = self.P = parts
        assert n % P == 0, "n must divide evenly across partitions"
        self.npp = n // P  # bits per partition
        # offset-space layout, identical in every partition
        self.a_off = list(range(2, 2 + self.npp))
        self.x_off = list(range(2 + self.npp, 2 + 2 * self.npp))
        if 2 + 2 * self.npp + 4 > self.cp:
            raise RuntimeError(f"n={n} too wide: {self.npp} bits/partition "
                               f"needs {2*self.npp+6} ≤ {self.cp} columns")
        self.wout = 1 + max(1, math.ceil(math.log2(n + 1)))
        self.count_off: List[int] = []   # filled by _build
        self.y_off: int = -1
        self.program = self._build()

    # -- helpers --------------------------------------------------------------

    def _par(self, gate: str, in_offs, out_off) -> List[ColOp]:
        """One gate at the same offsets in every partition (1 cycle)."""
        cp = self.cp
        return [ColOp(gate, tuple(p * cp + o for o in in_offs), p * cp + out_off)
                for p in range(self.P)]

    def _build(self) -> Program:
        P, cp, npp, m = self.P, self.cp, self.npp, self.m
        prog: Program = []
        zero_cols = [p * cp for p in range(P)]
        one_cols = [p * cp + 1 for p in range(P)]
        spare = [o for o in range(2, cp) if o not in set(self.a_off + self.x_off)]
        work = sorted([p * cp + o for p in range(P) for o in spare + [0, 1]])
        prog.append([InitOp(slice(None), work, 0)])
        prog.append([ColOp("NOT", (z,), o, None)
                     for z, o in zip(zero_cols, one_cols)])

        alloc = _OffsetAlloc(spare)

        # Phase 1: duplicate x down all m rows (masked to x columns)
        x_cols_all = sorted(p * cp + o for p in range(P) for o in self.x_off)
        prog += duplicate_band(0, (0, m), self.rp, cols=x_cols_all)

        # Phase 2: XNOR products (2 cycles each, P-way parallel); inputs die
        t_off = alloc.take(1, prog, P, cp)[0]
        prod_off: List[int] = []
        for j in range(npp):
            po = alloc.take(1, prog, P, cp)[0]
            prog.append(self._par("NAND2", (self.a_off[j], self.x_off[j]), t_off))
            prog.append(self._par("OAI3", (self.a_off[j], self.x_off[j], t_off), po))
            prod_off.append(po)
            alloc.kill([self.a_off[j], self.x_off[j]])

        # Phase 3: in-partition tree popcount (pairwise adds, growing width),
        # P-way parallel; consumed fields recycle.
        c0, c1, tt, uu = alloc.take(4, prog, P, cp)
        vals: List[List[int]] = [[o] for o in prod_off]
        while len(vals) > 1:
            nxt: List[List[int]] = []
            for i in range(0, len(vals) - 1, 2):
                af, bf = vals[i], vals[i + 1]
                w = max(len(af), len(bf)) + 1
                of = alloc.take(w, prog, P, cp)
                # ripple add in offset space (4 cycles/bit, P-way parallel)
                carry = 0  # offset of const-0
                for b, o in enumerate(of):
                    ab = af[b] if b < len(af) else 0
                    bb = bf[b] if b < len(bf) else 0
                    nxtc = c0 if carry != c0 else c1
                    prog.append(self._par("MIN3", (ab, bb, carry), tt))
                    prog.append(self._par("NOT", (tt,), nxtc))
                    prog.append(self._par("MIN5", (ab, bb, carry, tt, tt), uu))
                    prog.append(self._par("NOT", (uu,), o))
                    carry = nxtc
                alloc.kill(af + bf)
                nxt.append(of)
            if len(vals) % 2 == 1:
                nxt.append(vals[-1])
            vals = nxt
        part_count = vals[0]  # per-partition popcount, len ≈ log2(npp)+1

        # widen to wout bits (pad offsets with const-0 reads during adds)
        self.count_off = part_count

        # Phase 4: inter-partition reduction tree (log2 P levels). Pairs are
        # hypercube-aligned ⇒ disjoint merged spans ⇒ each level interleaves.
        # Result accumulates into partition p's columns with growing width.
        count_fields: List[List[int]] = [
            [p * cp + o for o in part_count] for p in range(P)
        ]
        stride = 1
        width = len(part_count)
        while stride < P:
            width += 1
            # destination needs `width` columns: extend with a fresh offset
            ext = alloc.take(1, prog, P, cp)[0]
            level: List[Program] = []
            for p in range(0, P, 2 * stride):
                q = p + stride
                dst = count_fields[p] + [p * cp + ext]
                sub = A_.emit_ripple_add(
                    count_fields[q], count_fields[p], dst,
                    (p * cp + c0, p * cp + c1, p * cp + tt, p * cp + uu), zero=p * cp)
                level.append(sub)
                count_fields[p] = dst
            prog += A_.interleave(level)
            stride *= 2
        total = count_fields[0]  # popcount of all n bits, in partition 0

        # Phase 5: majority threshold y = [count ≥ n/2] by adding −n/2 in
        # two's complement (constants read from const-0/const-1 columns).
        W = max(self.wout, len(total) + 1)
        ext = alloc.take(W - len(total), prog, P, cp)
        total = total + [0 * cp + e for e in ext]  # extend in partition 0
        neg = (-(self.n // 2)) % (1 << W)
        const_field = [1 if (neg >> b) & 1 else 0 for b in range(W)]  # offsets!
        prog += A_.emit_ripple_add(const_field, total, total,
                                   (c0, c1, tt, uu), zero=0)
        y_off = alloc.take(1, prog, P, cp)[0]
        prog += A_.emit_not(total[W - 1], y_off)
        self.y_off = y_off
        self._total_field = total
        self.W = self._W = W  # public: decoded popcount-field width (bits)
        return prog

    # -- host entry points ----------------------------------------------------

    def kernel_spec(self):
        from .kernel_exec import binary_matvec_spec
        return binary_matvec_spec(self)

    def load_into(self, mem: np.ndarray, A: np.ndarray, x: np.ndarray) -> None:
        """Write ±1 operands into a (rows, cols) crossbar image."""
        m, n, P, npp, cp = self.m, self.n, self.P, self.npp, self.cp
        assert A.shape == (m, n) and x.shape == (n,)
        a_cols = np.array([p * cp + self.a_off[j]
                           for p in range(P) for j in range(npp)])
        x_cols = np.array([p * cp + self.x_off[j]
                           for p in range(P) for j in range(npp)])
        mem[:m, a_cols] = (A > 0).astype(np.uint8)
        mem[0, x_cols] = (x > 0).astype(np.uint8)

    def decode_popcount(self, mem: np.ndarray) -> np.ndarray:
        """Raw per-row popcount of XNOR matches (host-reducible tile partial)."""
        W = self._W
        shifted = decode_uint(mem[: self.m][:, self._total_field])
        return (shifted + self.n // 2) % (1 << W)

    def decode_y(self, mem: np.ndarray) -> np.ndarray:
        return np.where(mem[: self.m, self.y_off] > 0, 1, -1)

    def run(self, A: np.ndarray, x: np.ndarray,
            xbar: Optional[Crossbar] = None, backend: str = "torch",
            device="cuda") -> Tuple[np.ndarray, np.ndarray, int]:
        """A, x in {−1,+1}. Returns (y_majority ∈ {−1,+1}, popcount, cycles)."""
        out, cycles, _ = self.run_program(
            lambda mem: self.load_into(mem, A, x), xbar, backend, device)
        return self.decode_y(out), self.decode_popcount(out), cycles


def matpim_binary_matvec(A: np.ndarray, x: np.ndarray,
                         backend: str = "torch", device="cuda", **kw):
    m, n = A.shape
    plan = BinaryMatvecPlan(m, n, **kw)
    return plan.run(A, x, backend=backend, device=device)


# ---------------------------------------------------------------------------
# Naive baseline (the N=1 special case of [MultPIM/FloatPIM]): serial XNOR +
# full-width counter increment per element — what MatPIM's 39× is against.
# ---------------------------------------------------------------------------


class NaiveBinaryMatvecPlan(CrossbarPlan):
    def __init__(self, m: int, n: int, rows: int = 1024, cols: int = 1024,
                 parts: int = 32):
        assert m <= rows and 2 * n + 32 <= cols - 2
        self.m, self.n = m, n
        self.rows, self.cols, self.parts = rows, cols, parts
        self.rp = rows // parts
        self.W = max(1, math.ceil(math.log2(n + 1)))
        c = iter(range(2, cols))
        self.zero, self.one = 0, 1
        self.a_cols = [next(c) for _ in range(n)]
        self.x_cols = [next(c) for _ in range(n)]
        self.counter = [next(c) for _ in range(self.W + 1)]
        self.scratch = [next(c) for _ in range(5)]
        self.program = self._build()

    def _build(self) -> Program:
        prog: Program = [
            [InitOp(slice(None), self.counter + self.scratch + [0, 1], 0)],
            [ColOp("NOT", (self.zero,), self.one, None)],
        ]
        prog += duplicate_band(0, (0, self.m), self.rp, cols=self.x_cols)
        for j in range(self.n):
            prog += A_.emit_xnor(self.a_cols[j], self.x_cols[j],
                                 self.scratch[4], t=self.scratch[0])
            prog += A_.emit_increment_by_bit(
                self.scratch[4], self.counter[: self.W],
                (self.scratch[0], self.scratch[1], self.scratch[2],
                 self.scratch[3]), self.zero)
        W = self.W + 1
        neg = (-(self.n // 2)) % (1 << W)
        const_field = [self.one if (neg >> b) & 1 else self.zero
                       for b in range(W)]
        prog += A_.emit_ripple_add(const_field, self.counter, self.counter,
                                   tuple(self.scratch[:4]), self.zero)
        prog += A_.emit_not(self.counter[W - 1], self.scratch[4])
        return prog

    def run(self, A: np.ndarray, x: np.ndarray, backend: str = "torch",
            device="cuda") -> Tuple[np.ndarray, int]:
        m = self.m

        def load(mem):
            mem[:m, self.a_cols] = (A > 0).astype(np.uint8)
            mem[0, self.x_cols] = (x > 0).astype(np.uint8)

        out, cycles, _ = self.run_program(load, None, backend, device)
        y = np.where(out[:m, self.scratch[4]] > 0, 1, -1)
        return y, cycles
