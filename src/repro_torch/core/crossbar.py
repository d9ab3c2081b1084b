"""Cycle-accurate memristive crossbar simulator.

Host-side numpy, a verbatim copy of ``src/repro/core/crossbar.py`` so the
port's programs match the reference's cycle for cycle.

Models a ``rows x cols`` binary crossbar with ``row_parts x col_parts``
memristive partitions (MatPIM evaluates 1024x1024 with 32x32). Algorithms
issue *cycles*; each cycle is a list of micro-ops that must be physically
co-schedulable:

* all ops in a cycle share one mode (column / row / init);
* column-mode ops occupy pairwise-disjoint *column-partition groups*
  (the contiguous span of partitions covering the op's columns — crossing a
  partition boundary merges the partitions via the isolation transistors);
* row-mode ops likewise occupy disjoint row-partition groups;
* init cycles drive any set of rectangles to a constant (bulk SET/RESET).

The simulator both *executes* (so algorithm outputs can be checked against
NumPy oracles) and *validates* the parallelism that MatPIM's latency claims
rely on, then reports the cycle count.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .isa import GATES, ColOp, InitOp, MicroOp, RowOp


class SchedulingError(RuntimeError):
    """A cycle contained ops that cannot physically execute together."""


# -- partition-group helpers (shared with the compile-time validator) ---------


def col_group(op: ColOp, cols: int, cp_size: int) -> Tuple[int, int]:
    cs = op.cols()
    lo, hi = min(cs), max(cs)
    if not (0 <= lo and hi < cols):
        raise SchedulingError(f"column out of range: {cs}")
    return (lo // cp_size, hi // cp_size)


def row_group(op: RowOp, rows: int, rp_size: int) -> Tuple[int, int]:
    rs = op.rows()
    lo, hi = min(rs), max(rs)
    if not (0 <= lo and hi < rows):
        raise SchedulingError(f"row out of range: {rs}")
    return (lo // rp_size, hi // rp_size)


def groups_disjoint(groups: Sequence[Tuple[int, int]]) -> bool:
    ordered = sorted(groups)
    for (a0, a1), (b0, b1) in zip(ordered, ordered[1:]):
        if b0 <= a1:
            return False
    return True


def init_rect(mem: np.ndarray, op: InitOp) -> None:
    """Apply an ``InitOp`` with rectangle semantics for every index combo.

    Slices index directly; any fancy selection (list / tuple / ndarray / int)
    is normalised to an index array, and two fancy axes go through ``np.ix_``
    so they always select the outer-product rectangle — plain
    ``mem[list_a, list_b]`` would zip them element-wise instead.
    """
    rows_sel, cols_sel = op.rows, op.cols
    r_fancy = not isinstance(rows_sel, slice)
    c_fancy = not isinstance(cols_sel, slice)
    if r_fancy:
        rows_sel = np.atleast_1d(np.asarray(rows_sel, dtype=np.intp))
    if c_fancy:
        cols_sel = np.atleast_1d(np.asarray(cols_sel, dtype=np.intp))
    if r_fancy and c_fancy:
        mem[np.ix_(rows_sel, cols_sel)] = op.value
    else:
        mem[rows_sel, cols_sel] = op.value


class Crossbar:
    """Per-op reference interpreter (the slow, always-validating baseline the
    compiled executors in :mod:`.engine` are property-tested against).

    >>> xb = Crossbar(4, 4, 1, 1)
    >>> xb.load(0, 0, np.array([[1, 0]]))
    >>> xb.run([[ColOp("NOT", (0,), 2, None)]])      # col 2 := NOT(col 0)
    >>> int(xb.mem[0, 2]), int(xb.mem[1, 2]), xb.cycles
    (0, 1, 1)
    """

    def __init__(
        self,
        rows: int = 1024,
        cols: int = 1024,
        row_parts: int = 32,
        col_parts: int = 32,
        validate: bool = True,
    ):
        assert rows % row_parts == 0 and cols % col_parts == 0
        self.rows = rows
        self.cols = cols
        self.row_parts = row_parts
        self.col_parts = col_parts
        self.rp_size = rows // row_parts
        self.cp_size = cols // col_parts
        self.mem = np.zeros((rows, cols), dtype=np.uint8)
        self.cycles = 0
        self.validate = validate
        # op-category counters for reporting
        self.stats = {"col_ops": 0, "row_ops": 0, "init_cycles": 0, "gate_evals": 0}

    # -- data loading / readout (not counted as compute cycles) ------------

    def load(self, row0: int, col0: int, bits: np.ndarray) -> None:
        bits = np.asarray(bits, dtype=np.uint8)
        if bits.ndim == 1:
            bits = bits[None, :]
        r, c = bits.shape
        self.mem[row0 : row0 + r, col0 : col0 + c] = bits

    def read(self, rows: slice, cols: slice) -> np.ndarray:
        return self.mem[rows, cols].copy()

    # -- partition-group computation ----------------------------------------

    def _col_group(self, op: ColOp) -> Tuple[int, int]:
        return col_group(op, self.cols, self.cp_size)

    def _row_group(self, op: RowOp) -> Tuple[int, int]:
        return row_group(op, self.rows, self.rp_size)

    _disjoint = staticmethod(groups_disjoint)

    # -- execution -----------------------------------------------------------

    def cycle(self, ops: Sequence[MicroOp]) -> None:
        """Execute one cycle containing the given co-scheduled micro-ops."""
        if not ops:
            return
        kinds = {type(op) for op in ops}
        if len(kinds) != 1:
            raise SchedulingError(f"mixed op modes in one cycle: {kinds}")
        kind = kinds.pop()

        if kind is InitOp:
            for op in ops:
                init_rect(self.mem, op)
            self.stats["init_cycles"] += 1
        elif kind is ColOp:
            if self.validate and not self._disjoint([self._col_group(o) for o in ops]):
                raise SchedulingError(
                    "column ops overlap column-partition groups: "
                    + ", ".join(str(self._col_group(o)) for o in ops)
                )
            # snapshot semantics: all reads happen before writes
            writes = []
            for op in ops:
                gate = GATES[op.gate]
                assert gate.arity == len(op.in_cols), op
                rows = op.rows if op.rows is not None else slice(None)
                ins = [self.mem[rows, c] for c in op.in_cols]
                writes.append((rows, op.out_col, gate.fn(*ins).astype(np.uint8)))
                self.stats["gate_evals"] += 1
            for rows, c, val in writes:
                self.mem[rows, c] = val
            self.stats["col_ops"] += len(ops)
        elif kind is RowOp:
            if self.validate and not self._disjoint([self._row_group(o) for o in ops]):
                raise SchedulingError("row ops overlap row-partition groups")
            writes = []
            for op in ops:
                gate = GATES[op.gate]
                assert gate.arity == len(op.in_rows), op
                cols = op.cols if op.cols is not None else slice(None)
                ins = [self.mem[r, cols] for r in op.in_rows]
                writes.append((op.out_row, cols, gate.fn(*ins).astype(np.uint8)))
                self.stats["gate_evals"] += 1
            for r, cols, val in writes:
                self.mem[r, cols] = val
            self.stats["row_ops"] += len(ops)
        else:
            raise SchedulingError(f"unknown op kind {kind}")
        self.cycles += 1

    def run(self, program: Sequence[Sequence[MicroOp]]) -> None:
        for ops in program:
            self.cycle(ops)


# ---------------------------------------------------------------------------
# Number encode/decode helpers (two's complement, LSB-first within the field)
# ---------------------------------------------------------------------------


def encode_uint(values: np.ndarray, nbits: int) -> np.ndarray:
    """Encode integers as LSB-first bit matrices of shape (..., nbits).

    >>> encode_uint(np.array([5]), 4)[0].tolist()
    [1, 0, 1, 0]
    """
    values = np.asarray(values, dtype=np.int64)
    shifts = np.arange(nbits, dtype=np.int64)
    return ((values[..., None] >> shifts) & 1).astype(np.uint8)


def decode_uint(bits: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode_uint` (fields wider than 62 bits decode into
    exact Python ints).

    >>> int(decode_uint(np.array([1, 0, 1, 0])))
    5
    """
    bits = np.asarray(bits, dtype=np.int64)
    nbits = bits.shape[-1]
    if nbits > 62:  # avoid int64 overflow: exact Python-int arithmetic
        weights = np.array([1 << i for i in range(nbits)], dtype=object)
        return (bits.astype(object) * weights).sum(axis=-1)
    shifts = np.arange(nbits, dtype=np.int64)
    return (bits << shifts).sum(axis=-1)


def decode_int(bits: np.ndarray) -> np.ndarray:
    """Two's-complement decode (MSB is the sign bit).

    >>> int(decode_int(np.array([1, 1, 1, 1])))
    -1
    """
    u = decode_uint(bits)
    nbits = np.asarray(bits).shape[-1]
    return np.where(u >= (1 << (nbits - 1)), u - (1 << nbits), u)
