"""Shared crossbar layout conventions for the MatPIM algorithms.

Host-side numpy, a verbatim copy of ``src/repro/core/layout.py`` so the
port's programs match the reference's cycle for cycle.

Per-partition reserved offsets (every column partition, cp_size columns):

    offset 0      : constant-0 column
    offset 1      : constant-1 column (NOT of offset 0, initialised once)
    offsets 2..11 : carry-save multiplier lanes
                    (a, a_alt, bcast, pp, t, u, S0, S1, C0, C1)
    offsets 12+   : data (allocated round-robin across partitions)

Row duplication (broadcasting a source row down a band of rows) uses
chunk-doubling at row-partition granularity:

    * fill the source row's own 32-row partition serially (31 copies), then
    * double partition-chunks: level ℓ copies 32 rows chunk-to-chunk
      (serial within a chunk-pair, parallel across disjoint chunk pairs).

    cycles(m) = (min(m,rp) - 1) + rp * ceil(log2(m / rp))   [rp = rows/partition]

Bands whose boundaries are row-partition-aligned duplicate concurrently.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from . import arithmetic as A
from .arithmetic import Program
from .isa import ColOp, InitOp, RowOp


class PartitionLayout:
    """Column bookkeeping for one crossbar; see module docstring."""

    N_LANE = 10

    def __init__(self, cols: int = 1024, col_parts: int = 32, with_one: bool = False):
        self.cols = cols
        self.P = col_parts
        self.cp = cols // col_parts
        if self.cp < self.N_LANE + 3:
            raise ValueError("partitions too narrow for lane layout")
        self.zero = 0
        self.with_one = with_one
        lane = lambda off: [p * self.cp + off for p in range(self.P)]
        self.lanes = A.MultLanes(
            P=self.P,
            a=lane(2), a_alt=lane(3), bcast=lane(4), pp=lane(5),
            t=lane(6), u=lane(7),
            S=[lane(8), lane(9)], C=[lane(10), lane(11)],
        )
        # data columns, round-robin across partitions so fields interleave;
        # offset 1 (const-1) is reserved only when requested (binary algos)
        offsets = list(range(12, self.cp)) + ([] if with_one else [1])
        self.data_cols: List[int] = [
            p * self.cp + off for off in offsets for p in range(self.P)
        ]
        self._next = 0

    def alloc(self, n: int) -> List[int]:
        if self._next + n > len(self.data_cols):
            raise RuntimeError(
                f"crossbar column budget exceeded: need {n}, "
                f"have {len(self.data_cols) - self._next}"
            )
        out = self.data_cols[self._next : self._next + n]
        self._next += n
        return out

    def alloc_in_partition(self, n: int, p: int) -> List[int]:
        lo, hi = p * self.cp, (p + 1) * self.cp
        avail = [c for c in self.data_cols[self._next :] if lo <= c < hi]
        # mark them used by removing from the pool (order-preserving)
        take = set(avail[:n])
        if len(take) < n:
            raise RuntimeError(f"partition {p} column budget exceeded")
        rest = [c for c in self.data_cols[self._next :] if c not in take]
        self.data_cols = self.data_cols[: self._next] + rest
        return sorted(take)

    def init_program(self, extra_cols: Sequence[int] = ()) -> Program:
        """Bulk-init workspace columns to 0 (one cycle) + const-1 per partition.

        Only lane/const/workspace columns are initialised — never data fields
        (the host loads those before execution).
        """
        zero_cols = [p * self.cp + 0 for p in range(self.P)]
        one_cols = [p * self.cp + 1 for p in range(self.P)] if self.with_one else []
        lane_cols = [p * self.cp + off for p in range(self.P) for off in range(2, 12)]
        cols = sorted(set(zero_cols + one_cols + lane_cols + list(extra_cols)))
        prog: Program = [[InitOp(slice(None), cols, 0)]]
        if self.with_one:
            prog.append([ColOp("NOT", (z,), o, None) for z, o in zip(zero_cols, one_cols)])
        return prog

    def zero_col(self, partition: int = 0) -> int:
        return partition * self.cp + 0

    def one_col(self, partition: int = 0) -> int:
        return partition * self.cp + 1


def duplicate_band(src_row: int, band: Tuple[int, int], rp_size: int, cols=None) -> Program:
    """Broadcast ``src_row`` to all rows of ``band`` [lo, hi) — hypercube chunks.

    ``src_row`` must be ``band[0]``. The source chunk (one row partition) is
    filled serially, then whole 32-row chunks propagate with the XOR-hypercube
    pattern: at level h each holder chunk c copies to chunk ``c ^ 2^h``. Every
    copy pair lies inside an aligned block of row partitions, so the chunk
    copies of one level run concurrently (rows within a chunk serially):

        cycles(m) ≈ (min(m, rp) - 1) + rp * ceil(log2(m / rp))

    This is cheaper than the O(m) serial duplication in MatPIM's latency
    expressions; see docs/ALGORITHMS.md (Fidelity note).
    """
    lo, hi = band
    assert src_row == lo
    m = hi - lo
    prog: Program = []
    first = min(m, rp_size)
    for r in range(lo + 1, lo + first):
        prog.append([RowOp("OR2", (src_row, src_row), r, cols)])
    n_chunks = math.ceil(m / rp_size)
    if n_chunks <= 1:
        return prog
    levels = math.ceil(math.log2(n_chunks))
    holders = [0]
    for h in reversed(range(levels)):
        new = []
        # each holder chunk copies to c ^ 2^h; all pairs in disjoint aligned
        # blocks; rows within the chunk go one per cycle, chunks in parallel
        targets = []
        for c in holders:
            q = c ^ (1 << h)
            if q < n_chunks:
                targets.append((c, q))
                new.append(q)
        for r_off in range(rp_size):
            cyc = []
            for c, q in targets:
                src = lo + c * rp_size + r_off
                dst = lo + q * rp_size + r_off
                if src < hi and dst < hi:
                    cyc.append(RowOp("OR2", (src, src), dst, cols))
            if cyc:
                prog.append(cyc)
        holders += new
    return prog


def duplicate_band_cycles(m: int, rp_size: int) -> int:
    """Latency of ``duplicate_band`` (derived from the generator itself)."""
    return len(duplicate_band(0, (0, m), rp_size))
