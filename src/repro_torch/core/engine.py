"""Batched torch executors for compiled crossbar traces.

The port of ``src/repro/core/engine.py``. A :class:`~repro_torch.core.compile.
CompiledProgram` (host-side numpy, byte-identical to the reference's) replays
over a batch of B independent crossbars on a torch device:

* ``torch-unfused`` — per-cycle replay, the counterpart of the reference's
  ``_run_numpy``: one gather / gate-eval / masked-scatter per gate group per
  cycle.
* ``torch-fused`` — span-batched replay of the macro-op schedule, the
  counterpart of ``run_numpy_fused`` (see :mod:`.fused`).
* ``torch`` — fused when the trace carries a schedule, else unfused.
* ``kernels`` — runs the *algorithm* an eligible trace encodes on the
  hand-written kernels (see :mod:`.kernel_exec`); ineligible traces replay
  on ``torch`` with the label ``kernels:fallback-torch``.
* ``auto`` — resolves one of the above per ``(program key, batch bucket)``
  from the autotuner's tunings table, else its heuristic (see
  :mod:`.autotune`); results are labelled ``auto:<resolved>[@max_batch]``.

The reference's ``mesh`` (multi-device execution, ``distributed/
mesh_exec.py``) is not ported: passing it raises ``NotImplementedError``.

Every entry point takes an explicit ``device``, ``"cuda"`` by default. When
CUDA is missing and the caller did not ask for the CPU, the call raises
rather than carrying on quietly on the CPU.

Canonical packed-word layout
----------------------------
Memory lives on the device transposed and bit-packed over the batch: a
``(W, cols+1, rows+1)`` word buffer with ``W = word_count(B) = ceil(B/32)``;
bit ``b`` of ``buf[w, c, r]`` is cell ``(r, c)`` of crossbar ``32w + b``.
Words are held as ``torch.int32`` carrying the reference's uint32 bits
(torch has no shifts for ``uint32`` on the CPU), converted with ``.view`` at
the numpy boundary. Every FELIX gate is a short boolean word expression
(``BIT_GATES``), so one gather and a few bitwise ops simulate a gate across
32 crossbars. The extra row and column (index ``rows`` / ``cols``) are the
constant-0 gather slot; writes never touch them.

All backends are bit-identical to the reference's numpy executors in final
memory, cycle count and op-category stats (``tests/test_torch_engine.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device.faults import FaultRealization, make_fault_source
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .compile import MODE_COL, MODE_INIT, MODE_ROW, CompiledProgram

# boolean word implementations of the FELIX suite, indexed by GATE_IDS.
# MINk (k-input minority) is NOT(majority); MIN5 goes through two full adders:
# a+b+c = 2*maj(a,b,c) + (a^b^c), then fold in d, e.


def _maj3(a, b, c):
    return (a & b) | ((a ^ b) & c)


def _min5(a, b, c, d, e):
    s1 = a ^ b ^ c
    c1 = _maj3(a, b, c)
    s2 = d ^ e ^ s1
    c2 = _maj3(d, e, s1)
    # a+..+e = 2*(c1+c2) + s2  =>  sum >= 3  <=>  (c1&c2) | ((c1^c2)&s2)
    return ~((c1 & c2) | ((c1 ^ c2) & s2))


# (arity, word function) per GATE_IDS slot; executors gather exactly `arity`
# input lines per op
BIT_GATES = (
    (1, lambda a: ~a),                              # NOT
    (2, lambda a, b: a | b),                        # OR2
    (2, lambda a, b: ~(a | b)),                     # NOR2
    (3, lambda a, b, c: ~(a | b | c)),              # NOR3
    (2, lambda a, b: ~(a & b)),                     # NAND2
    (3, lambda a, b, c: ~_maj3(a, b, c)),           # MIN3
    (5, _min5),                                     # MIN5
    (3, lambda a, b, c: ~((a | b) & c)),            # OAI3
)

# the concrete backends ``execute`` runs; it also takes "auto" (see
# ``available_backends``), and ``CrossbarPlan`` methods take "interp" (the
# host interpreter)
BACKENDS = ("torch", "torch-fused", "torch-unfused", "kernels")


def available_backends() -> tuple:
    """Every backend ``execute`` accepts for compiled traces: ``"auto"``
    and the concrete :data:`BACKENDS`.

    >>> available_backends()
    ('auto', 'torch', 'torch-fused', 'torch-unfused', 'kernels')
    """
    return ("auto",) + BACKENDS


def parse_backend(backend: str) -> tuple:
    """``backend`` → ``(base, variant)`` with base in {auto, torch,
    kernels} and variant in {auto, fused, unfused}.

    >>> parse_backend("torch"), parse_backend("torch-unfused")
    (('torch', 'auto'), ('torch', 'unfused'))
    >>> parse_backend("kernels"), parse_backend("auto")
    (('kernels', 'auto'), ('auto', 'auto'))
    """
    base, variant = backend, "auto"
    if backend.endswith("-fused"):
        base, variant = backend[:-len("-fused")], "fused"
    elif backend.endswith("-unfused"):
        base, variant = backend[:-len("-unfused")], "unfused"
    if base != "torch" and not (base in ("auto", "kernels")
                                and variant == "auto"):
        known = ", ".join(repr(b) for b in available_backends())
        raise ValueError(
            f"unknown engine backend {backend!r}; compiled traces support "
            f"{known} ('interp' is plan-level only: use "
            f"CrossbarPlan.execute)")
    return base, variant


def resolve_device(device="cuda") -> torch.device:
    """The torch device a run goes to; raises when CUDA is asked for and
    missing, so a run never falls back to the CPU unannounced."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class EngineResult:
    mem: np.ndarray        # (B, rows, cols) uint8 final memory state
    cycles: int            # == len(program) by construction
    stats: Dict[str, int]  # interpreter-identical op-category counters
    backend: str
    faults: object = None  # FaultRealization the run was under


# ---------------------------------------------------------------------------
# Canonical bit-plane pack / unpack: (W, C+1, R+1) int32 words on the device
# ---------------------------------------------------------------------------

# bits per packed word — THE word width of the canonical layout
WORD_BITS = 32


def word_count(B: int) -> int:
    """Packed words covering a batch of ``B`` crossbars: ``ceil(B / 32)``.

    >>> word_count(1), word_count(32), word_count(33), word_count(128)
    (1, 1, 2, 4)
    """
    if B < 1:
        raise ValueError(f"batch must be positive, got {B}")
    return -(-int(B) // WORD_BITS)


def as_int32_words(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` → int32 words holding the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def words_to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words → device int32 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


def _pack(mem: torch.Tensor) -> torch.Tensor:
    """(B, R, C) uint8 → canonical (W, C+1, R+1) int32 packed buffer, on
    ``mem``'s device. Word ``w`` packs crossbars ``[32w, 32w+32)``; unused
    high bits of the last word stay zero."""
    B, R, C = mem.shape
    buf = torch.zeros((word_count(B), C + 1, R + 1), dtype=torch.int32,
                      device=mem.device)
    for w in range(buf.shape[0]):
        acc = torch.zeros((R, C), dtype=torch.int64, device=mem.device)
        for b, plane in enumerate(mem[WORD_BITS * w:WORD_BITS * (w + 1)]):
            acc |= plane.to(torch.int64) << b
        buf[w, :C, :R] = as_int32_words(acc).T
    return buf


def _unpack(buf: torch.Tensor, B: int, R: int, C: int) -> torch.Tensor:
    """Inverse of :func:`_pack`: (W, C+1, R+1) int32 → (B, R, C) uint8.
    ``>>`` on int32 sign-extends, so every extracted bit is masked."""
    words = buf[:, :C, :R].transpose(1, 2)           # (W, R, C)
    out = torch.empty((B, R, C), dtype=torch.uint8, device=buf.device)
    for w in range(buf.shape[0]):
        lo = WORD_BITS * w
        bw = min(WORD_BITS, B - lo)
        shifts = torch.arange(bw, dtype=torch.int32,
                              device=buf.device).view(-1, 1, 1)
        out[lo:lo + bw] = ((words[w] >> shifts) & 1).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# Replay plans: gate groups with device-resident index tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Group:
    """Same-gate ops of one replay step (a cycle, or a fused span)."""

    gid: int
    arity: int
    dst: torch.Tensor        # (n,) written lines
    ins: torch.Tensor        # (n, arity) gathered lines
    mask: torch.Tensor       # (n, R1) col mode / (C1, n) row mode, bool
    full: bool               # every write mask selects all real lines
    t_runs: list             # [(t, compile slots)] in op order (faults)


def _full_mask_ids(masks: np.ndarray, size: int) -> frozenset:
    return frozenset(
        int(i) for i, m in enumerate(masks)
        if m[:size].all() and not m[size:].any())


def _keep_last(dst: np.ndarray) -> np.ndarray:
    """Indices of the last op writing each line, in op order.

    The reference's numpy scatter ``buf[:, d] = new`` lets the last of
    duplicate destinations win, while torch's advanced-index assignment
    with duplicates is unordered. Dropping every earlier duplicate makes the
    torch scatter deterministic and equal to numpy's. Validated programs
    never have duplicates inside one step (distinct partition groups within
    a cycle, no write-after-write inside a span); this guards the rest.
    """
    _, first_rev = np.unique(dst[::-1], return_index=True)
    return np.sort(len(dst) - 1 - first_rev)


def _group(cp: CompiledProgram, mode: int, gid: int, dst, ins, sel, ts,
           slots, full_ids: frozenset, device) -> _Group:
    keep = _keep_last(dst)
    dst, ins, sel, ts, slots = dst[keep], ins[keep], sel[keep], ts[keep], \
        slots[keep]
    arity = BIT_GATES[gid][0]
    mask = (cp.row_masks[sel] if mode == MODE_COL else cp.col_masks[sel].T)
    t_runs = [(int(t), slots[ts == t]) for t in np.unique(ts)]
    return _Group(
        gid=int(gid), arity=arity,
        dst=torch.from_numpy(np.ascontiguousarray(dst, np.int64)).to(device),
        ins=torch.from_numpy(
            np.ascontiguousarray(ins[:, :arity], np.int64)).to(device),
        mask=torch.from_numpy(np.ascontiguousarray(mask)).to(device),
        full=all(int(s) in full_ids for s in sel), t_runs=t_runs)


def _step_groups(cp: CompiledProgram, mode: int, gates, dsts, inss, sels,
                 ts, slots, device) -> List[_Group]:
    """One replay step's ops (concatenated in cycle-major order) grouped by
    gate id."""
    full_ids = _full_mask_ids(cp.row_masks if mode == MODE_COL
                              else cp.col_masks,
                              cp.rows if mode == MODE_COL else cp.cols)
    return [_group(cp, mode, gid, *(a[gates == gid] for a in
                                    (dsts, inss, sels, ts, slots)),
                   full_ids=full_ids, device=device)
            for gid in np.unique(gates)]


def _init_entries(cp: CompiledProgram, t: int, device) -> list:
    """Bulk-init rectangles of cycle ``t``: (col idx, row idx, value, i,
    host col idx, host row idx)."""
    ents = []
    for i in range(cp.I):
        rm = cp.row_masks[cp.init_r[t, i]]
        cm = cp.col_masks[cp.init_c[t, i]]
        if rm.any() and cm.any():
            c_np, r_np = np.nonzero(cm)[0], np.nonzero(rm)[0]
            ents.append((torch.from_numpy(c_np).to(device)[:, None],
                         torch.from_numpy(r_np).to(device)[None, :],
                         int(cp.init_v[t, i]), t, i, c_np, r_np))
    return ents


def _cycle_plan(cp: CompiledProgram, device) -> list:
    """Per-cycle replay plan (memoized per device): one step per cycle."""
    key = ("torch_plan", str(device))
    plan = cp._caches.get(key)
    if plan is not None:
        return plan
    plan = []
    for t in range(cp.n_cycles):
        mode = int(cp.mode[t])
        if mode == MODE_INIT:
            plan.append((MODE_INIT, _init_entries(cp, t, device)))
            continue
        n = int(cp.nops[t])
        slots = np.arange(n)
        plan.append((mode, _step_groups(
            cp, mode, cp.gate[t, :n], cp.dst[t, :n], cp.ins[t, :n],
            cp.sel[t, :n], np.full(n, t), slots, device)))
    cp._caches[key] = plan
    return plan


def _fail_words(src, g: _Group, mode: int, device) -> torch.Tensor:
    """Switching-failure words for group ``g``: (W, n, R1) in col mode,
    (W, C1, n) in row mode."""
    if mode == MODE_COL:
        parts = [src.switch_col(t, s, len(s)) for t, s in g.t_runs]
        return words_to_device(np.concatenate(parts, axis=1), device)
    parts = [src.switch_row(t, s, len(s)) for t, s in g.t_runs]
    return words_to_device(np.concatenate(parts, axis=2), device)


def _replay(cp: CompiledProgram, buf: torch.Tensor, plan: list, src) -> None:
    """Replay ``plan`` on ``buf`` in place.

    Snapshot semantics: within a step every group gathers its inputs before
    any group scatters, exactly like the interpreter's within-cycle rule
    (and the fused spans' pre-span reads). ``src`` is a fault source or
    ``None``; with faults the ``full`` shortcut is skipped, as in the
    reference's faulty replay.
    """
    R, C = cp.rows, cp.cols
    dev = buf.device
    if src is not None:
        sa0, sa1 = (words_to_device(a, dev) for a in src.stuck())
        buf.copy_((buf | sa1) & ~sa0)            # cells are stuck from t=0
    for mode, items in plan:
        if mode == MODE_INIT:
            for ci, ri, v, t, i, c_np, r_np in items:
                if src is None:
                    buf[:, ci, ri] = -1 if v else 0
                    continue
                blk = torch.full((buf.shape[0], len(c_np), len(r_np)),
                                 -1 if v else 0, dtype=torch.int32,
                                 device=dev)
                flip = src.init_flip(t, i, c_np, r_np)
                if flip is not None:
                    blk ^= words_to_device(flip, dev)
                buf[:, ci, ri] = (blk | sa1[:, ci, ri]) & ~sa0[:, ci, ri]
            continue
        col = mode == MODE_COL
        outs = []
        for g in items:
            if col:
                x = buf[:, g.ins]                  # (W, n, arity, R1)
                lines = (x[:, :, k] for k in range(g.arity))
            else:
                x = buf[:, :, g.ins]               # (W, C1, n, arity)
                lines = (x[..., k] for k in range(g.arity))
            outs.append(BIT_GATES[g.gid][1](*lines))
        for g, out in zip(items, outs):
            if src is None and g.full:
                # data lines only: the const-0 row/column must stay zero
                if col:
                    buf[:, g.dst, :R] = out[..., :R]
                else:
                    buf[:, :C, g.dst] = out[:, :C]
                continue
            old = buf[:, g.dst] if col else buf[:, :, g.dst]
            new = torch.where(g.mask, out, old)
            if src is not None:
                if src.has_switch:
                    fail = _fail_words(src, g, mode, dev)
                    new = (old & fail) | (new & ~fail)
                s0 = sa0[:, g.dst] if col else sa0[:, :, g.dst]
                s1 = sa1[:, g.dst] if col else sa1[:, :, g.dst]
                new = (new | s1) & ~s0
            if col:
                buf[:, g.dst] = new
            else:
                buf[:, :, g.dst] = new


def run_plan(cp: CompiledProgram, mem: torch.Tensor, plan: list,
             faults=None) -> torch.Tensor:
    """Pack ``mem`` (B, R, C) uint8 on its device, replay ``plan``, unpack."""
    B = mem.shape[0]
    src = make_fault_source(faults, None, B, cp.rows, cp.cols)
    buf = _pack(mem)
    _replay(cp, buf, plan, src)
    return _unpack(buf, B, cp.rows, cp.cols)


def run_torch_unfused(cp: CompiledProgram, mem: torch.Tensor,
                      faults=None) -> torch.Tensor:
    """Per-cycle replay of ``cp`` over ``mem`` (B, R, C) uint8 on a device."""
    return run_plan(cp, mem, _cycle_plan(cp, mem.device), faults)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def execute(
    cp: CompiledProgram,
    mem: np.ndarray,
    backend: str = "torch",
    device="cuda",
    max_batch: Optional[int] = None,
    faults=None,
    tunings=None,
    mesh=None,
) -> EngineResult:
    """Replay ``cp`` over a batch of crossbars on ``device``.

    ``mem`` is ``(B, rows, cols)`` (or ``(rows, cols)`` for B=1) uint8
    initial state on the host; it is not mutated. The batch moves to the
    device once, packs into the canonical ``(W, cols+1, rows+1)`` word
    layout and runs in one executor call (``max_batch`` splits it into
    chunks); the final memory comes back as a host array. Every chunk runs
    the identical program, so the reported cycle count is unchanged.

    ``faults`` takes a :class:`~repro_torch.device.faults.FaultRealization`
    (explicit per-cycle masks, bit-identical to the reference's numpy
    replay under the same masks). A ``FaultModel`` raises
    ``NotImplementedError``: its sampling (``device/faults.py``) is not
    ported. So does ``mesh``: multi-device execution
    (``distributed/mesh_exec.py``) is not ported.

    ``backend="auto"`` resolves a concrete backend (and optionally a
    span-chunking ``max_batch``) per ``(program key, batch bucket)`` from
    the tunings table — ``tunings`` (a
    :class:`repro_torch.core.autotune.TuningTable`) overrides the process
    default — else the autotuner's heuristic; the result's ``backend``
    field reads ``"auto:<resolved>[@max_batch]"``. A resolved ``kernels``
    whose trace the kernels cannot compute keeps the fallback's own label,
    ``kernels:fallback-torch``.

    Telemetry matches the reference: a ``span("engine.execute")`` and the
    ``engine.execute.calls[.<label>]`` counters and
    ``engine.execute.wall_us.<label>`` histogram in :mod:`repro_torch.obs`
    (the label without its ``@max_batch`` suffix).
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= needs multi-device execution (distributed/mesh_exec.py), "
            "which is not ported to repro_torch")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with _span("engine.execute", backend=backend) as sp:
        res = _execute_impl(cp, mem, backend, dev, max_batch, faults,
                            tunings)
        sp.set(resolved=res.backend, cycles=res.cycles)
    wall_us = (time.perf_counter() - t0) * 1e6
    label = res.backend.split("@", 1)[0]
    _metrics.counter("engine.execute.calls").inc()
    _metrics.counter(f"engine.execute.calls.{label}").inc()
    _metrics.histogram(f"engine.execute.wall_us.{label}").observe(wall_us)
    if isinstance(faults, FaultRealization):
        _metrics.counter("engine.execute.fault_runs").inc()
    return res


def _execute_impl(cp: CompiledProgram, mem: np.ndarray, backend: str,
                  device: torch.device, max_batch: Optional[int],
                  faults, tunings=None) -> EngineResult:
    from .fused import run_torch_fused, schedule_for
    from .kernel_exec import kernels_eligible, run_kernels

    squeeze = mem.ndim == 2
    if squeeze:
        mem = mem[None]
    if mem.shape[1:] != (cp.rows, cp.cols):
        raise ValueError(f"memory shape {mem.shape} does not match the "
                         f"trace geometry {(cp.rows, cp.cols)}")
    mem_t = torch.from_numpy(
        np.array(mem, dtype=np.uint8, order="C")).to(device)

    base, variant = parse_backend(backend)
    label = backend
    if base == "auto":
        from .autotune import resolve_auto
        resolved, mb, _src = resolve_auto(cp, mem_t.shape[0], faults=faults,
                                          table=tunings)
        base, variant = parse_backend(resolved)
        if max_batch is None and mb is not None:
            max_batch = mb
        label = (f"auto:{resolved}@{mb}" if mb is not None
                 else f"auto:{resolved}")
    if base == "kernels":
        if kernels_eligible(cp, faults):
            out = run_kernels(cp, mem_t).cpu().numpy()
            return EngineResult(mem=out[0] if squeeze else out,
                                cycles=cp.n_cycles, stats=dict(cp.stats),
                                backend=label)
        variant, label = "auto", "kernels:fallback-torch"
    B = mem_t.shape[0]
    step = min(B, max(1, int(max_batch))) if max_batch else B
    if variant == "auto":
        variant = ("fused" if isinstance(faults, FaultRealization)
                   or cp.schedule is not None else "unfused")
    if variant == "fused":
        schedule_for(cp)             # attach on demand for fuse=False traces
    if isinstance(faults, FaultRealization) and faults.batch != B:
        raise ValueError(
            f"FaultRealization batch {faults.batch} != memory batch {B}; "
            f"sample the realization for the batch it will run under")

    run = run_torch_fused if variant == "fused" else run_torch_unfused
    chunks = []
    for i in range(0, B, step):
        sub = mem_t[i:i + step]
        f = (faults.narrow(i, i + sub.shape[0])
             if isinstance(faults, FaultRealization) else faults)
        chunks.append(run(cp, sub, f))
    out = (chunks[0] if len(chunks) == 1 else torch.cat(chunks)).cpu().numpy()
    return EngineResult(mem=out[0] if squeeze else out, cycles=cp.n_cycles,
                        stats=dict(cp.stats), backend=label, faults=faults)
