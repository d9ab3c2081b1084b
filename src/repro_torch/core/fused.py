"""Fused (macro-op segment) torch executor for compiled crossbar traces.

The port of the numpy half of ``src/repro/core/fused.py``. ``torch-fused``
(:func:`run_torch_fused`) replays each segment's *independent spans* of the
:class:`~repro_torch.core.compile.FusedSchedule` as single batched device
calls — one gather / gate-eval / masked-scatter per gate group per span
instead of one per cycle — and skips the trace-global op padding (segments
carry their own, usually much narrower, width). It is the counterpart of
the reference's ``run_numpy_fused``, with its snapshot rule: every group of
a span gathers against pre-span memory before any group scatters.

Faults are drawn per span step in the per-cycle order: every (cycle, gate
id) block of the span, cycle ascending and gate id ascending within a
cycle, into one word array that each gate group indexes — so a
``FaultModel`` consumes its numpy stream exactly as the per-cycle replay
and the reference's numpy replays do, and a ``FaultRealization`` (explicit
masks looked up by original cycle and compile slot) gives the same masks
however the replay is batched.

Cycle accounting is untouched by construction: fusion changes how many
*simulator* steps replay the trace, never how many *hardware* cycles the
trace costs (``FusedSchedule.n_cycles == CompiledProgram.n_cycles``).
"""
from __future__ import annotations

import numpy as np
import torch

from .compile import (MAX_FANIN, MODE_INIT, CompiledProgram, FusedSchedule,
                      fuse_program)
from .engine import (_cycle_plan, _init_entries, _step_groups, run_plan,
                     tables_ready)


def schedule_for(cp: CompiledProgram) -> FusedSchedule:
    """``cp.schedule``, computing and attaching it if compiled unfused."""
    if cp.schedule is None:
        cp.schedule = fuse_program(cp)
    return cp.schedule


def prewarm_replay(cp: CompiledProgram, device="cuda") -> None:
    """Build ``cp``'s replay plan for ``device`` ahead of the first batch.

    Deriving the replay structure (span grouping, device index tables) is
    paid once per program and device; calling this moves that cost out of
    the first request. Memoized on ``cp._caches`` like every executor
    artifact, so it is always correct and at worst a no-op.
    """
    device = torch.empty(0, device=device).device   # "cuda" -> "cuda:0"
    if cp.schedule is not None:
        _fused_plan(cp, device)
    else:
        _cycle_plan(cp, device)


def _fused_plan(cp: CompiledProgram, device) -> list:
    """Span-batched replay plan (memoized per device): one step per
    independent span of every gate segment, one per cycle of every init
    segment."""
    key = ("torch_fused_plan", str(device))
    plan = cp._caches.get(key)
    if plan is not None:
        return plan
    plan = []
    for seg in schedule_for(cp).segments:
        if seg.mode == MODE_INIT:
            for t in range(seg.t0, seg.t1):
                plan.append((MODE_INIT, _init_entries(cp, t, device)))
            continue
        for a, b in seg.spans:
            js = range(a, b)
            n = [int(seg.nops[j]) for j in js]
            cat = np.concatenate
            plan.append((seg.mode, _step_groups(
                cp, seg.mode,
                cat([seg.gate[j, :k] for j, k in zip(js, n)]),
                cat([seg.dst[j, :k] for j, k in zip(js, n)]),
                cat([seg.ins[j, :k] for j, k in zip(js, n)]).reshape(
                    -1, MAX_FANIN),
                cat([seg.sel[j, :k] for j, k in zip(js, n)]),
                cat([np.full(k, seg.t0 + j) for j, k in zip(js, n)]),
                cat([seg.perm[j, :k] for j, k in zip(js, n)]),
                device)))
    tables_ready(device)
    cp._caches[key] = plan
    return plan


def run_torch_fused(cp: CompiledProgram, mem: torch.Tensor,
                    faults=None, rng=None) -> torch.Tensor:
    """Fused replay of ``cp`` over ``mem`` (B, R, C) uint8 on its device.

    Bit-identical to the per-cycle executor and to the reference's numpy
    replays, with or without faults; a ``FaultModel`` draws from ``rng`` in
    the per-cycle order (see :class:`~repro_torch.core.engine._Step`).
    """
    return run_plan(cp, mem, _fused_plan(cp, mem.device), faults, rng)
