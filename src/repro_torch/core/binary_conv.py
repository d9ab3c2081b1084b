"""MatPIM §III-C: fast binary 2D convolution.

A (m×n) and K (k×k) are ±1 (bit-encoded 0 ↔ −1, 1 ↔ +1); the output is the
quantized sign:  Out[r,c] = sign Σ_{v,h} A[r+v,c+h]·K[v,h], i.e.
``popcount ≥ ⌈k²/2⌉`` of the XNOR products.

Following §III-A/C, the input-parallel loop runs vert-outer with destructive
whole-row vertical shifts (amortized across the full row), and every column
partition processes its resident output columns concurrently — the
"inner product within a single partition" division of §III-C.

Implementation choices (see docs/ALGORITHMS.md §Beyond-paper choices):

* **K-specialized products**: the controller reads the k² kernel bits once
  and emits XNOR(a, K)=a (copy) or NOT(a) directly — no kernel duplication.
* **Biased counters**: each output column accumulates its popcount in a
  4-bit counter pre-biased with (8 − ⌈k²/2⌉) so the majority output is just
  the counter's MSB — no threshold subtraction.
* **Tap passes**: per-partition column budget fits ⌈nout_pp/3⌉ counters, so
  the (vert, hori) taps run in up to 3 passes; consecutive passes alternate
  shift-up / shift-down sweeps so no restore pass is needed.

Cycle formula and paper mapping: docs/ALGORITHMS.md §III-C.

The port of ``src/repro/core/binary_conv.py``: the program generator is the
reference's, line for line, so traces match it byte for byte; execution
takes the port's backends and an explicit ``device``. The taps are baked
into the gates, so no kernel computes this trace: on ``backend="kernels"``
it replays on ``torch`` with the label ``kernels:fallback-torch``, as in
the reference, which has no ``pallas_spec`` for it.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .arithmetic import Program
from .crossbar import Crossbar
from .isa import ColOp, InitOp, RowOp
from .plan import CrossbarPlan


class BinaryConvPlan(CrossbarPlan):
    """±1-kernel conv: out = [XNOR-tap popcount ≥ ⌈k²/2⌉], in ±1.

    >>> plan = BinaryConvPlan(4, 8, 2, rows=64, cols=256, parts=8)
    >>> A = np.where(np.arange(32).reshape(4, 8) % 2 == 0, 1, -1)
    >>> out, cycles = plan.run(A, np.ones((2, 2)), device="cpu")
    >>> sorted(set(out.ravel().tolist()))    # every 2x2 window ties -> +1
    [1]
    """

    CTR_W = 4  # counter width; k*k <= 9 assumed (3x3); 5x5 uses 5 bits

    def __init__(self, m: int, n: int, k: int, rows: int = 1024,
                 cols: int = 1024, parts: int = 32):
        assert m <= rows
        self.m, self.n, self.k = m, n, k
        self.rows, self.cols, self.parts = rows, cols, parts
        self.rp = rows // parts
        self.cp = cols // parts
        self.P = parts
        self.n_out = n - k + 1
        self.m_out = m - k + 1
        self.ctr_w = max(4, math.ceil(math.log2(k * k + 1)) + 1)
        assert n % self.P == 0, "n must divide across partitions"
        self.npp = n // self.P                       # input bits per partition
        self.nout_pp = self.npp                      # out cols owned (≤ npp)

        # offset budget per partition: const0 | A npp | outs | counters | scr
        avail = self.cp - 1 - self.npp - 4 - 1       # scr c0,c1,t,u + prod
        per_pass = max(1, (avail - self.nout_pp) // self.ctr_w)
        self.cols_per_pass = min(per_pass, self.nout_pp)
        self.n_pass = math.ceil(self.nout_pp / self.cols_per_pass)
        if self.npp + self.nout_pp + self.cols_per_pass * self.ctr_w + 6 > self.cp:
            raise RuntimeError(f"binary conv n={n} does not fit")

        # offsets
        o = iter(range(1, self.cp))
        self.a_off = [next(o) for _ in range(self.npp)]
        self.out_off = [next(o) for _ in range(self.nout_pp)]
        self.ctr_off = [[next(o) for _ in range(self.ctr_w)]
                        for _ in range(self.cols_per_pass)]
        self.scr = [next(o) for _ in range(4)]  # c0, c1, t, u
        self.prod = next(o)
        self.program: Optional[Program] = None
        self.K: Optional[np.ndarray] = None

    # -- helpers -------------------------------------------------------------

    def _acol(self, p: int, local: int) -> int:
        """Absolute column of input bit ``local`` counted from partition p."""
        g = p * self.npp + local  # global input column index
        if g >= self.n:  # halo past the right edge (garbage out col): clamp
            return p * self.cp + self.a_off[0]
        return (g // self.npp) * self.cp + self.a_off[g % self.npp]

    def _emit_tap_products(self, hori: int, locals_: List[int], ctr_slot: int,
                           kbit: int) -> Program:
        """For each partition p and each local out col in ``locals_``:
        increment ctr[ctr_slot] by XNOR(A[c+hori], kbit). K-specialized:
        kbit=1 → increment by the A bit itself; kbit=0 → by NOT(A bit).
        Cross-partition reads (halo) are staggered even/odd."""
        prog: Program = []
        P, cp = self.P, self.cp
        for li, lc in enumerate(locals_):
            # source A bit for out col (p*npp + lc): global col + hori
            bit_cols = [self._acol(p, lc + hori) for p in range(P)]
            own = [p for p in range(P) if bit_cols[p] // cp == p]
            cross = [p for p in range(P) if bit_cols[p] // cp != p]

            def staggered(gate, p_list):
                """Emit gate(bit_col[p]) -> prod[p]; halo reads span up to
                d partitions, so phase by p % (d+1) to keep spans disjoint."""
                by_phase = {}
                for p in p_list:
                    d = (bit_cols[p] // cp) - p
                    by_phase.setdefault((d, p % (d + 1)) if d else 0, []).append(p)
                for key in sorted(by_phase, key=str):
                    ops = [ColOp(gate,
                                 (bit_cols[p], bit_cols[p]) if gate == "OR2"
                                 else (bit_cols[p],),
                                 p * cp + self.prod)
                           for p in by_phase[key]]
                    prog.append(ops)

            if kbit == 0:
                # prod = NOT(A): own partitions in one cycle, crossers phased
                if own:
                    staggered("NOT", own)
                if cross:
                    staggered("NOT", cross)
                srcs = [p * cp + self.prod for p in range(P)]
            elif cross:
                # copy the crossing bits into prod first, then use locally
                staggered("OR2", cross)
                srcs = [bit_cols[p] if p in set(own) else p * cp + self.prod
                        for p in range(P)]
            else:
                srcs = bit_cols
            # increment ctr[ctr_slot] by srcs bit — 4 cycles/ctr-bit, P-way
            c0, c1, t, u = self.scr
            carry_off = None  # offsets after first iteration
            ctr = self.ctr_off[ctr_slot]
            carry_cols = srcs
            for i, o_ in enumerate(ctr):
                nxt = c0 if carry_off != c0 else c1
                oc = [p * cp + o_ for p in range(P)]
                prog.append([ColOp("NAND2", (carry_cols[p], oc[p]), p * cp + t)
                             for p in range(P)])
                prog.append([ColOp("NOT", (p * cp + t,), p * cp + nxt)
                             for p in range(P)])
                prog.append([ColOp("OAI3", (carry_cols[p], oc[p], p * cp + t),
                                   p * cp + u) for p in range(P)])
                prog.append([ColOp("NOT", (p * cp + u,), oc[p])
                             for p in range(P)])
                carry_off = nxt
                carry_cols = [p * cp + nxt for p in range(P)]
        return prog

    def build(self, K: np.ndarray) -> Program:
        m, k, P, cp = self.m, self.k, self.P, self.cp
        Kbits = (K > 0).astype(np.uint8)
        prog: Program = []
        a_cols = sorted(p * cp + off for p in range(P) for off in self.a_off)
        work = sorted(set(p * cp + off for p in range(P)
                          for off in [0] + self.out_off + self.scr + [self.prod]
                          + [o for c in self.ctr_off for o in c]))
        prog.append([InitOp(slice(None), work, 0)])

        # Counter-shift formulation of Algorithm 1: instead of destructively
        # shifting A upward, the (narrower) counter field shifts DOWNWARD to
        # meet each A row — same masked-row-copy latency per shift, but A is
        # preserved so every tap pass is identical. Out[r]'s count ends at
        # crossbar row r+k-1 (``decode_out`` reads with that offset); row 0's
        # stale counter copies are never harvested.
        bias = (1 << (self.ctr_w - 1)) - math.ceil(k * k / 2)
        for q in range(self.n_pass):
            locals_ = list(range(q * self.cols_per_pass,
                                 min((q + 1) * self.cols_per_pass, self.nout_pp)))
            slots = list(range(len(locals_)))
            # (re-)init counters to the bias (MSB trick: out = ctr MSB)
            ctr_cols = sorted(p * cp + o for p in range(P)
                              for s in slots for o in self.ctr_off[s])
            prog.append([InitOp(slice(None), ctr_cols, 0)])
            one_bits = sorted(p * cp + self.ctr_off[s][b] for p in range(P)
                              for s in slots for b in range(self.ctr_w)
                              if (bias >> b) & 1)
            if one_bits:
                prog.append([InitOp(slice(None), one_bits, 1)])

            for vert in range(k):
                for hori in range(k):
                    for s, lc in zip(slots, locals_):
                        prog += self._emit_tap_products(
                            hori, [lc], s, int(Kbits[vert, hori]))
                if vert < k - 1:
                    # shift counters down one row (bottom-up, masked)
                    for r in range(m - 2, -1, -1):
                        prog.append([RowOp("OR2", (r, r), r + 1, ctr_cols)])

            # harvest outputs: out bit = counter MSB (bias trick), one
            # row-parallel copy per column slot
            for s, lc in zip(slots, locals_):
                prog.append([ColOp("OR2", (p * cp + self.ctr_off[s][-1],) * 2,
                                   p * cp + self.out_off[lc])
                             for p in range(P)])
        return prog

    # -- host entry points ----------------------------------------------------

    def ensure_program(self, K: np.ndarray) -> Program:
        if self.program is None or not np.array_equal(K, self.K):
            self.program = self.build(K)
            self.K = K.copy()
        return self.program

    def load_into(self, mem: np.ndarray, A: np.ndarray, K: np.ndarray) -> None:
        m, n, k = self.m, self.n, self.k
        assert A.shape == (m, n) and K.shape == (k, k)
        a_cols = np.array([p * self.cp + self.a_off[j]
                           for p in range(self.P) for j in range(self.npp)])
        mem[:m, a_cols] = (A > 0).astype(np.uint8)

    def decode_out(self, mem: np.ndarray) -> np.ndarray:
        k = self.k
        out = np.zeros((self.m_out, self.n_out), dtype=np.int64)
        c = np.arange(self.n_out)
        cols = (c // self.npp) * self.cp + np.array(self.out_off)[c % self.npp]
        # out[r] lives at crossbar row r + k - 1 (counter-shift offset)
        bits = mem[k - 1 : k - 1 + self.m_out][:, cols]
        out[:, :] = np.where(bits > 0, 1, -1)
        return out

    def run(self, A: np.ndarray, K: np.ndarray,
            xbar: Optional[Crossbar] = None, backend: str = "torch",
            device="cuda") -> Tuple[np.ndarray, int]:
        self.ensure_program(K)
        out, cycles, _ = self.run_program(
            lambda mem: self.load_into(mem, A, K), xbar, backend, device)
        return self.decode_out(out), cycles

    @property
    def cycles(self) -> int:
        if self.program is None:
            self.program = self.build(np.ones((self.k, self.k)))
        return len(self.program)


def matpim_binary_conv2d(A: np.ndarray, K: np.ndarray,
                         backend: str = "torch", device="cuda", **kw):
    m, n = A.shape
    plan = BinaryConvPlan(m, n, K.shape[0], **kw)
    return plan.run(A, K, backend=backend, device=device)
