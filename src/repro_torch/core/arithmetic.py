"""In-crossbar bit-serial arithmetic macros (row-parallel stateful logic).

Host-side numpy, a verbatim copy of ``src/repro/core/arithmetic.py`` so the
port's programs match the reference's cycle for cycle.

Every macro *emits a program*: ``list[list[MicroOp]]`` — a list of cycles,
each cycle a list of co-scheduled micro-ops. The crossbar simulator executes
and validates them. Latency is therefore ``len(program)`` by construction,
and ``latency.py`` mirrors these counts in closed form (test-enforced).

Conventions
-----------
* Numbers are unsigned, LSB-first bit *fields*: a ``Field`` is a list of
  column indices (arbitrary, possibly non-contiguous / strided across
  partitions).
* ``copy`` is an OR gate with tied inputs (1 cycle).
* Full adder (FELIX Min3/Min5 construction), 4 cycles serial:
      t  = MIN3(a, b, cin)        # = NOT(carry-out)
      c' = NOT(t)                 # carry-out
      u  = MIN5(a, b, cin, t, t)  # = NOT(sum)   [Maj5 identity]
      s  = NOT(u)                 # sum
* The carry-save multiplier spreads bit positions *strided* across column
  partitions (position p lives in partition ``p mod P``) so each partial-
  product step runs one gate per partition per cycle — this is the MultPIM
  partition parallelism MatPIM builds on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .isa import ColOp, InitOp, RowOp

Field = List[int]  # column indices, LSB first
Program = List[List[object]]  # list of cycles


# ---------------------------------------------------------------------------
# Scheduling helpers
# ---------------------------------------------------------------------------


def seq(*cycles) -> Program:
    return [list(c) if isinstance(c, (list, tuple)) else [c] for c in cycles]


def concat(*programs: Program) -> Program:
    out: Program = []
    for p in programs:
        out.extend(p)
    return out


def interleave(programs: Sequence[Program]) -> Program:
    """Co-schedule several programs: cycle t runs cycle t of each program.

    Callers must ensure partition-disjointness (the simulator validates).
    Total latency = max over the programs — this is how MatPIM's partition
    parallelism (e.g. all partitions popcounting concurrently) is expressed.
    """
    T = max((len(p) for p in programs), default=0)
    out: Program = []
    for t in range(T):
        cyc: List[object] = []
        for p in programs:
            if t < len(p):
                cyc.extend(p[t])
        out.append(cyc)
    return out


# ---------------------------------------------------------------------------
# Column allocator (scratch management within a crossbar)
# ---------------------------------------------------------------------------


class ColAlloc:
    """Allocates scratch columns, optionally pinned to a column partition."""

    def __init__(self, cols: int, cp_size: int, reserved: Sequence[int] = ()):
        self.cols = cols
        self.cp_size = cp_size
        self.free = [c for c in range(cols) if c not in set(reserved)]

    def take(self, n: int = 1, partition: Optional[int] = None) -> List[int]:
        if partition is None:
            picked, self.free = self.free[:n], self.free[n:]
        else:
            lo, hi = partition * self.cp_size, (partition + 1) * self.cp_size
            picked = [c for c in self.free if lo <= c < hi][:n]
            rest = set(picked)
            self.free = [c for c in self.free if c not in rest]
        if len(picked) < n:
            raise RuntimeError(f"out of columns (partition={partition})")
        return picked

    def give(self, cols: Sequence[int]) -> None:
        self.free.extend(cols)


# ---------------------------------------------------------------------------
# Primitive emitters (each returns a Program)
# ---------------------------------------------------------------------------


def emit_copy(src: int, dst: int, rows=None) -> Program:
    return [[ColOp("OR2", (src, src), dst, rows)]]


def emit_not(src: int, dst: int, rows=None) -> Program:
    return [[ColOp("NOT", (src,), dst, rows)]]


def emit_copy_field(src: Field, dst: Field, rows=None) -> Program:
    """Serial field copy (same partition group ⇒ one bit per cycle)."""
    return concat(*[emit_copy(s, d, rows) for s, d in zip(src, dst)])


def emit_full_adder(a: int, b: int, cin: int, s: int, cout: int,
                    t: int, u: int, rows=None) -> Program:
    """4-cycle FELIX full adder; ``t``/``u`` are scratch columns.

    A gate's output memristor is always distinct from its inputs (stateful-
    logic requirement), hence the second scratch.
    """
    return [
        [ColOp("MIN3", (a, b, cin), t, rows)],          # t = NOT(carry-out)
        [ColOp("NOT", (t,), cout, rows)],
        [ColOp("MIN5", (a, b, cin, t, t), u, rows)],    # u = NOT(sum)
        [ColOp("NOT", (u,), s, rows)],
    ]


def emit_ripple_add(
    a: Field,
    b: Field,
    out: Field,
    scratch: Tuple[int, int, int, int],
    zero: int,
    rows=None,
) -> Program:
    """``out = a + b`` (unsigned, ripple carry), 4 cycles/bit.

    Widths may differ; missing operand bits read the constant-zero column.
    ``out`` may alias ``b`` (in-place accumulate). ``scratch`` = (c0, c1, t, u):
    two carry columns (ping-pong) + two temps. Output width ``len(out)``;
    overflow wraps (the final carry is dropped).
    """
    c0, c1, t, u = scratch
    prog: Program = []
    carry = zero  # cin of bit 0 is the constant-zero column
    for i, o in enumerate(out):
        ai = a[i] if i < len(a) else zero
        bi = b[i] if i < len(b) else zero
        nxt = c0 if carry != c0 else c1
        prog += emit_full_adder(ai, bi, carry, o, nxt, t, u, rows)
        carry = nxt
    return prog


def emit_increment_by_bit(
    bit: int, counter: Field, scratch: Tuple[int, int, int, int], zero: int,
    rows=None,
) -> Program:
    """counter += bit, half-adder ripple (the *naive* popcount counter).

    Per counter bit (4 cycles): t = NAND(c,x); carry-out = NOT(t);
    u = OAI3(c,x,t) = XNOR(c,x); sum = NOT(u).
    """
    c0, c1, t, u = scratch
    prog: Program = []
    carry = bit
    for i, o in enumerate(counter):
        nxt = c0 if carry != c0 else c1
        prog += [
            [ColOp("NAND2", (carry, o), t, rows)],        # t = (c·x)'
            [ColOp("NOT", (t,), nxt, rows)],              # carry-out = c·x
            [ColOp("OAI3", (carry, o, t), u, rows)],      # u = XNOR(c, x)
            [ColOp("NOT", (u,), o, rows)],                # o = XOR = sum
        ]
        carry = nxt
    return prog


# ---------------------------------------------------------------------------
# Broadcast / shift across partitions
# ---------------------------------------------------------------------------


def emit_bisection_broadcast(src_col: int, dst_cols: Sequence[int], cp_size: int, rows=None) -> Program:
    """Broadcast one bit to one column in each of P partitions in log2(P)+1 cycles.

    Hypercube pattern: at level h each holder p copies to p XOR 2^h. Every
    copy pair lies inside an aligned 2^(h+1)-partition block, so all copies
    of a level have pairwise-disjoint partition spans ⇒ one cycle per level
    (the simulator validates this). Works from any source partition.
    """
    P = len(dst_cols)
    assert P & (P - 1) == 0, "P must be a power of two"
    prog: Program = []
    src_p = src_col // cp_size
    prog += emit_copy(src_col, dst_cols[src_p], rows)
    holders = [src_p]
    for h in reversed(range(P.bit_length() - 1)):
        cyc = []
        new = []
        for p in holders:
            q = p ^ (1 << h)
            cyc.append(ColOp("OR2", (dst_cols[p], dst_cols[p]), dst_cols[q], rows))
            new.append(q)
        prog.append(cyc)
        holders += new
    return prog


# ---------------------------------------------------------------------------
# Carry-save partition-parallel multiplier (MultPIM-style)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultLanes:
    """Per-partition lane columns for the strided carry-save multiplier.

    Position p (0..2N-1) lives in partition ``p % P``. Each partition hosts
    ``ceil(2N/P)`` positions; for the canonical N=32, P=32 each partition
    hosts exactly two positions (p and p+32) — only one is *active* per step.
    """

    P: int                      # number of partitions used
    a: List[int]                # a-bit column per partition (live buffer)
    a_alt: List[int]            # a-bit double buffer (for the per-step shift)
    bcast: List[int]            # broadcast multiplier bit, per partition
    pp: List[int]               # partial-product scratch, per partition
    t: List[int]                # FA scratch (MIN3 out), per partition
    u: List[int]                # FA scratch (MIN5 out), per partition
    S: List[List[int]]          # S[pos_slot][partition]: sum bits (carry-save)
    C: List[List[int]]          # C[pos_slot][partition]: carry bits


def _pos_cols(lanes: MultLanes, pos: int) -> Tuple[int, int]:
    return lanes.S[pos // lanes.P][pos % lanes.P], lanes.C[pos // lanes.P][pos % lanes.P]


def mult_lo_field(lanes: MultLanes, N: int) -> Field:
    """Columns holding product bits 0..N-1 after ``emit_mult(..., lo_only=True)``.

    Retired bit t stays in the S column of position t (never touched after
    step t), so the low half of the product needs no extra columns at all.
    """
    return [lanes.S[pos // lanes.P][pos % lanes.P] for pos in range(N)]


def emit_mult(
    a: Field,
    b: Field,
    out: Optional[Field],
    lanes: MultLanes,
    zero: int,
    rows=None,
    cp_size: int = 32,
    lo_only: bool = False,
    b_const: Optional[int] = None,
) -> Program:
    """``out = a * b`` (unsigned, len(out) = 2N), carry-save across partitions.

    Per step t (N steps):
      1. broadcast b_t to all P partitions             — log2(P) + 1 cycles
      2. shift the a-bits one partition up (staggered) — 2 cycles (+wrap)
      3. pp = AND(a, bcast) per partition              — 2 cycles
      4. carry-save FA per active position             — 4 cycles
         (MIN3 | staggered cross-partition carry NOT ×2 | MIN5+NOT merged)
      5. retire out bit t (position t is final)        — 1 cycle
    then a final carry-propagate add resolves positions N..2N-1.

    ``lo_only=True``: skip (5) and the CPA; product bits 0..N-1 remain in the
    S lanes (see ``mult_lo_field``) and ``out`` may be None.
    ``b_const``: controller-specialized multiply for a known multiplier
    (beyond-paper optimization): steps with b_t=0 feed the per-partition
    const-0 column, steps with b_t=1 feed ``a`` directly — no broadcast, no
    AND. Requires the const-0 offset replicated in every partition.
    """
    N = len(a)
    P = lanes.P
    prog: Program = []
    zero_off = zero % cp_size
    zeros = [p * cp_size + zero_off for p in range(P)]

    # load a into lane buffers: bit j starts at partition j % P (pos = j at t=0)
    for j, col in enumerate(a):
        prog += emit_copy(col, lanes.a[j % P], rows)

    live_a, alt_a = lanes.a, lanes.a_alt
    for t_step in range(N):
        # (1) broadcast b_t to every partition's bcast column
        if b_const is None:
            prog += emit_bisection_broadcast(b[t_step], lanes.bcast, cp_size, rows)

        # (2) shift a one partition up (skip at t=0: already in place)
        if t_step > 0:
            evens = [
                ColOp("OR2", (live_a[p], live_a[p]), alt_a[(p + 1) % P], rows)
                for p in range(0, P, 2)
            ]
            odds = [
                ColOp("OR2", (live_a[p], live_a[p]), alt_a[(p + 1) % P], rows)
                for p in range(1, P, 2)
            ]
            # the wrap copy (P-1 → 0) spans every partition: schedule it alone
            wrap = [o for o in odds if (int(o.in_cols[0]) // cp_size) == P - 1]
            odds = [o for o in odds if o not in wrap]
            prog.append(evens)
            if odds:
                prog.append(odds)
            if wrap:
                prog.append(wrap)
            live_a, alt_a = alt_a, live_a

        # (3) pp = a AND bcast (2 cycles, all partitions parallel).
        # With a known multiplier (b_const) the AND is free: pp is `a` itself
        # when b_t=1 and the const-0 column when b_t=0.
        if b_const is None:
            prog.append([ColOp("NAND2", (live_a[p], lanes.bcast[p]), lanes.pp[p], rows) for p in range(P)])
            prog.append([ColOp("NOT", (lanes.pp[p],), lanes.pp[p], rows) for p in range(P)])
            pp_src = lanes.pp
        elif (b_const >> t_step) & 1:
            pp_src = live_a
        else:
            pp_src = zeros

        # (4) carry-save FA at active positions t..t+N-1 (one per partition)
        active = list(range(t_step, t_step + N))
        # which partition hosts each active position: {pos % P} — all distinct
        min3, carry_even, carry_odd, carry_wrap, min5, nots = [], [], [], [], [], []
        for pos in active:
            p = pos % P
            S_col, C_col = _pos_cols(lanes, pos)
            # a-bit for position pos at step t is in partition p (by the shift)
            min3.append(ColOp("MIN3", (pp_src[p], S_col, C_col), lanes.t[p], rows))
            # carry-out of pos is consumed at pos+1 next step → write C[pos+1];
            # staggered even/odd pairs; the wrap write (P-1 → 0) spans every
            # partition so it gets its own cycle
            _, C_next = _pos_cols(lanes, pos + 1)
            op = ColOp("NOT", (lanes.t[p],), C_next, rows)
            if p == P - 1 and ((pos + 1) % P) == 0:
                carry_wrap.append(op)
            else:
                (carry_even if p % 2 == 0 else carry_odd).append(op)
            min5.append(ColOp("MIN5", (pp_src[p], S_col, C_col, lanes.t[p], lanes.t[p]), lanes.u[p], rows))
            nots.append(ColOp("NOT", (lanes.u[p],), S_col, rows))
        # order: MIN3 and MIN5 both read C *before* the staggered carry
        # writes overwrite C[pos+1] for the next step (RAW-hazard-free)
        prog.append(min3)
        prog.append(min5)
        prog.append(nots)
        prog.append(carry_even)
        if carry_odd:
            prog.append(carry_odd)
        if carry_wrap:
            prog.append(carry_wrap)

        # (5) retire output bit t (spans partitions; scheduled alone)
        if not lo_only:
            S_col, _ = _pos_cols(lanes, t_step)
            prog += emit_copy(S_col, out[t_step], rows)

    if lo_only:
        return prog  # product bits 0..N-1 live in the S lanes (mult_lo_field)

    # final carry-propagate over positions N..2N-1:  out_hi = S_hi + C_hi
    hiS = [_pos_cols(lanes, pos)[0] for pos in range(N, 2 * N)]
    hiC = [_pos_cols(lanes, pos)[1] for pos in range(N, 2 * N)]
    # ripple: serial anyway; reuse t of partition 0 area — need 3 scratch cols
    c0, c1, tt, uu = lanes.t[0], lanes.t[1], lanes.t[2], lanes.u[0]
    prog += emit_ripple_add(hiS, hiC, out[N:], (c0, c1, tt, uu), zero, rows)
    return prog


# ---------------------------------------------------------------------------
# Tree popcount (MatPIM §II-B, optimization 1: tree instead of counter)
# ---------------------------------------------------------------------------


def emit_tree_popcount(
    bits: Field,
    out: Field,
    alloc_cols: List[int],
    zero: int,
    rows=None,
) -> Program:
    """Popcount of ``len(bits)`` bits via a pairwise adder tree (serial).

    Level ℓ sums pairs of (ℓ+1)-bit numbers into (ℓ+2)-bit numbers — the
    growing-width tree the paper uses instead of a fixed-width counter.
    ``alloc_cols`` is scratch (≥ 4*len(bits) columns recommended). All ops
    stay inside the caller's partition: latency is the serial gate count,
    which ``interleave`` then parallelizes across partitions.
    """
    pool = list(alloc_cols)

    def take(n):
        nonlocal pool
        got, pool = pool[:n], pool[n:]
        if len(got) < n:
            raise RuntimeError("popcount scratch exhausted")
        return got

    prog: Program = []
    vals: List[Field] = [[b] for b in bits]
    c0, c1, tt, uu = take(4)
    while len(vals) > 1:
        nxt: List[Field] = []
        for i in range(0, len(vals) - 1, 2):
            a_f, b_f = vals[i], vals[i + 1]
            w = max(len(a_f), len(b_f)) + 1
            o = take(w)
            prog += emit_ripple_add(a_f, b_f, o, (c0, c1, tt, uu), zero, rows)
            nxt.append(o)
        if len(vals) % 2 == 1:
            nxt.append(vals[-1])
        vals = nxt
    res = vals[0]
    for i, o in enumerate(out):
        prog += emit_copy(res[i] if i < len(res) else zero, o, rows)
    return prog


# ---------------------------------------------------------------------------
# XNOR (binary product in ±1 encoding: 0 ↔ -1, 1 ↔ +1)
# ---------------------------------------------------------------------------


def emit_xnor(a: int, b: int, out: int, t: int, rows=None) -> Program:
    """XNOR in 2 cycles via FELIX OAI3: XNOR(a,b) = OAI3(a, b, NAND(a,b))."""
    return [
        [ColOp("NAND2", (a, b), t, rows)],
        [ColOp("OAI3", (a, b, t), out, rows)],
    ]


# ---------------------------------------------------------------------------
# Row duplication (vector broadcast down the rows) and vertical shift
# ---------------------------------------------------------------------------


def emit_duplicate_rows(src_row: int, dst_rows: Sequence[int], cols=None) -> Program:
    """Copy one row into each of ``dst_rows``, 1 cycle per row (serial).

    Long-distance row copies span many row partitions, so they serialize —
    this is the O(m) duplication cost in MatPIM's latency expressions.
    """
    return [[RowOp("OR2", (src_row, src_row), r, cols)] for r in dst_rows]


def emit_vertical_shift_up(rows0: int, rows1: int, cols) -> Program:
    """Shift rows [rows0+1, rows1) up by one, restricted to ``cols`` (a slice).

    Row r ← row r+1, executed top-down so reads see pre-shift values; each
    copy is column-parallel across the whole field (this full-row amortization
    is MatPIM's input-parallel advantage), serial across rows.
    """
    return [[RowOp("OR2", (r + 1, r + 1), r, cols)] for r in range(rows0, rows1 - 1)]
