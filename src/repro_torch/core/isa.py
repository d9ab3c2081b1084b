"""Stateful-logic ISA for the memristive crossbar (FELIX gate suite).

Host-side numpy, a verbatim copy of ``src/repro/core/isa.py`` so the
port's programs match the reference's cycle for cycle.

MatPIM evaluates on a crossbar supporting the FELIX [Gupta+, ICCAD'18] suite
of single-cycle stateful gates. We model the following 1-cycle primitives:

    NOT, OR2, NOR2, NOR3, NAND2, MIN3, MIN5, OAI3

where ``MINk`` is the k-input minority gate (FELIX demonstrates single-cycle
fan-in>2 gates) and ``OAI3(a,b,c) = ((a|b)&c)'`` (FELIX's or-and-inverter,
which yields a 2-cycle XNOR: ``XNOR(a,b) = OAI3(a,b,NAND(a,b))``).

Composite helpers (AND2 = NAND+NOT etc.) live in ``arithmetic.py`` and are
built from these primitives so that every cycle the simulator counts
corresponds to one physically executable parallel gate step.

Two execution modes exist per cycle (voltages are applied either to bitlines
or to wordlines, never both):

* **column mode** (``ColOp``, row-parallel): a gate whose operands/output are
  *columns*; it executes simultaneously in every selected row. Concurrent
  ``ColOp``s in one cycle must occupy pairwise-disjoint column-partition
  groups (a group = the contiguous partitions spanned by the op's columns,
  merged via the inter-partition isolation transistors).
* **row mode** (``RowOp``, column-parallel): a gate whose operands/output are
  *rows*; executes simultaneously in every selected column. Concurrency is
  across disjoint row-partition groups.

``InitOp`` models the bulk SET/RESET used to initialise output memristors:
an arbitrary rectangular region is driven to 0/1 in one cycle (standard
whole-array reset capability; initialisation is counted explicitly, one
cycle per issued ``InitOp`` batch).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Gate definitions
# ---------------------------------------------------------------------------


def _not(a):
    return 1 - a


def _or2(a, b):
    return a | b


def _nor2(a, b):
    return 1 - (a | b)


def _nor3(a, b, c):
    return 1 - (a | b | c)


def _nand2(a, b):
    return 1 - (a & b)


def _min3(a, b, c):
    # minority = NOT(majority)
    return (a.astype(np.int32) + b + c < 2).astype(np.uint8)


def _min5(a, b, c, d, e):
    return (a.astype(np.int32) + b + c + d + e < 3).astype(np.uint8)


def _oai3(a, b, c):
    return 1 - ((a | b) & c)


@dataclasses.dataclass(frozen=True)
class Gate:
    name: str
    arity: int
    fn: Callable


GATES: Dict[str, Gate] = {
    "NOT": Gate("NOT", 1, _not),
    "OR2": Gate("OR2", 2, _or2),
    "NOR2": Gate("NOR2", 2, _nor2),
    "NOR3": Gate("NOR3", 3, _nor3),
    "NAND2": Gate("NAND2", 2, _nand2),
    "MIN3": Gate("MIN3", 3, _min3),
    "MIN5": Gate("MIN5", 5, _min5),
    "OAI3": Gate("OAI3", 3, _oai3),
}


# ---------------------------------------------------------------------------
# Micro-ops
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColOp:
    """Row-parallel gate: ``mem[rows, out_col] = gate(mem[rows, in_cols...])``."""

    gate: str
    in_cols: Tuple[int, ...]
    out_col: int
    rows: Optional[slice] = None  # None = all rows

    def cols(self) -> Tuple[int, ...]:
        return tuple(self.in_cols) + (self.out_col,)


@dataclasses.dataclass
class RowOp:
    """Column-parallel gate: ``mem[out_row, cols] = gate(mem[in_rows..., cols])``.

    ``cols`` may be a slice or an explicit list of columns: in row mode each
    column's gate is driven by its own bitline, so columns not participating
    simply have their bitlines floated (symmetric to row masking in column
    mode). The row-partition constraint applies to ``in_rows``/``out_row``.
    """

    gate: str
    in_rows: Tuple[int, ...]
    out_row: int
    cols: object = None  # None = all columns; slice or list otherwise

    def rows(self) -> Tuple[int, ...]:
        return tuple(self.in_rows) + (self.out_row,)


@dataclasses.dataclass
class InitOp:
    """Bulk SET/RESET of selected rows × columns to a constant bit."""

    rows: object  # slice or list
    cols: object  # slice or list
    value: int  # 0 or 1


MicroOp = object  # ColOp | RowOp | InitOp
