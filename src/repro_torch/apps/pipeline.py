"""Pipeline layer: compile multi-stage workloads end-to-end onto crossbars.

The port of ``src/repro/apps/pipeline.py``: every stage runs its tiles on a
torch ``device`` (``"cuda"`` by default), and the reports equal the
reference's.

The four MatPIM plans (and their tiled scale-out wrappers) each execute ONE
operation. Real mMPU applications — BNN inference, image-processing chains —
are *compositions*: the output of one in-memory operation becomes the operand
of the next. This module models that composition explicitly:

* a :class:`Stage` wraps one tiled crossbar operation (or a host-side
  elementwise fixup) and knows three things about itself: how to run, what
  its inter-stage **data movement** costs (crossbar→host reads of result
  fields, host→crossbar writes of the next operands — column-serial cycles
  via :func:`repro_torch.core.latency.host_io_cycles`, per-cell energy via
  :func:`repro_torch.device.energy.io_energy_fj`), and what its in-array
  execution costs (per-tile trace cycles × the device profile's cycle time;
  switching energy from the static trace pricing in
  :mod:`repro_torch.device.energy`);
* a :class:`Pipeline` chains stages, threading the execution backend
  (``torch``/``kernels``/``auto``/``interp``), the ``device`` and an
  optional stochastic :class:`~repro_torch.device.faults.FaultModel`
  through every stage, and returns a :class:`PipelineReport` with the
  per-stage cycle/energy/IO breakdown.

Weights/kernels are **array-resident** (weight-stationary): each stage's
matrix or kernel is programmed into its tile grid once, outside the steady
state, so per-invocation IO charges cover activations and results only.
Stage-to-stage activations always pass through the host — MatPIM has no
inter-array copy primitive — which is exactly the boundary this layer makes
visible and prices.

Stages fetch their tiled plans from a shared
:class:`~repro_torch.serve.matpim.PlanService` (the process-wide default,
on ``"cuda"``, unless a ``service`` is passed to the stage constructor): two
stages — or two whole pipelines, e.g. every sample of a Monte-Carlo fault
sweep — with the same shape, geometry and (for convs) kernel reuse ONE
compiled+fused plan instead of private recompiles. The service is a plan
cache here; where a stage runs is its ``run``'s ``device``.

>>> import numpy as np
>>> from repro_torch.serve import PlanService
>>> svc = PlanService(device="cpu")
>>> rng = np.random.default_rng(0)
>>> W1 = rng.choice([-1, 1], size=(16, 32))
>>> x = rng.choice([-1, 1], size=32)
>>> pipe = Pipeline([BinaryMatvecStage(W1, service=svc, rows=64, cols=256,
...                                    parts=8)])
>>> y, rep = pipe.run(x, device="cpu")
>>> bool(np.array_equal(y, np.where(W1 @ x >= 0, 1, -1)))
True
>>> rep.stages[0].cycles == pipe.stages[0].tiled.plan.cycles
True
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.latency import host_io_cycles
from ..core.tiling import majority_sign
from ..device.energy import get_profile, io_energy_fj


def _fetch_tiled(service, kind: str, *args, key_extra=None, **kw):
    """Stage plan source: the given
    :class:`~repro_torch.serve.matpim.PlanService` or the process-wide
    default. Deferred import keeps apps importable without the serve package
    loaded up front."""
    if service is None:
        from ..serve.matpim import get_default_service
        service = get_default_service()
    return service.tiled(kind, *args, key_extra=key_extra, **kw)


@dataclasses.dataclass
class StageReport:
    """Cost breakdown of one executed pipeline stage."""

    name: str
    kind: str                  # binary-matvec | matvec | conv | binary-conv | host
    cycles: int                # per-tile program length (tiles in lockstep)
    io_cycles: int             # column-serial host read+write at the boundary
    n_tiles: int
    reduce_depth: int          # host tree-reduction levels after the tiles
    array_nj: float            # switching energy of the whole tile grid
    io_nj: float               # boundary transfer energy (cells moved)
    t_cycle_ns: float
    backend: str = "host"      # engine label of the stage's tile batches

    @property
    def total_cycles(self) -> int:
        return self.cycles + self.io_cycles

    @property
    def total_nj(self) -> float:
        return self.array_nj + self.io_nj

    @property
    def latency_ns(self) -> float:
        return self.total_cycles * self.t_cycle_ns


@dataclasses.dataclass
class PipelineReport:
    """Per-stage reports plus whole-pipeline totals."""

    name: str
    backend: str
    profile: str
    stages: List[StageReport]

    @property
    def cycles(self) -> int:
        return sum(s.total_cycles for s in self.stages)

    @property
    def energy_nj(self) -> float:
        return sum(s.total_nj for s in self.stages)

    @property
    def latency_ns(self) -> float:
        return sum(s.latency_ns for s in self.stages)

    def __str__(self) -> str:
        head = (f"Pipeline {self.name} [{self.backend}, {self.profile}]: "
                f"{self.cycles} cycles, {self.energy_nj:.3f} nJ, "
                f"{self.latency_ns:.0f} ns")
        lines = [head,
                 f"  {'stage':<22} {'kind':<14} {'tiles':>5} {'cycles':>8} "
                 f"{'io_cyc':>6} {'red':>3} {'array_nJ':>10} {'io_nJ':>8}"]
        for s in self.stages:
            lines.append(f"  {s.name:<22} {s.kind:<14} {s.n_tiles:>5} "
                         f"{s.cycles:>8} {s.io_cycles:>6} {s.reduce_depth:>3} "
                         f"{s.array_nj:>10.3f} {s.io_nj:>8.4f}")
        return "\n".join(lines)


class Stage:
    """One pipeline step. Subclasses implement :meth:`_run` (execute over the
    crossbar substrate, return output + a :class:`StageReport`)."""

    name: str
    kind: str

    def _run(self, x, backend, max_batch, faults, rng, profile, device):
        raise NotImplementedError

    def run(self, x, backend: str = "torch", max_batch: Optional[int] = None,
            faults=None, rng=None, profile=None, device="cuda"
            ) -> Tuple[np.ndarray, StageReport]:
        return self._run(x, backend, max_batch, faults, rng,
                         get_profile(profile), device)

    def _report(self, prof, cycles, n_tiles, reduce_depth, array_fj,
                read_cols, write_cols, read_cells, write_cells,
                backend: str = "host") -> StageReport:
        return StageReport(
            name=self.name, kind=self.kind, cycles=int(cycles),
            io_cycles=host_io_cycles(read_cols, write_cols),
            n_tiles=int(n_tiles), reduce_depth=int(reduce_depth),
            array_nj=array_fj * 1e-6,
            io_nj=io_energy_fj(read_cells * n_tiles, write_cells * n_tiles,
                               prof) * 1e-6,
            t_cycle_ns=prof.t_cycle_ns, backend=backend)


class BinaryMatvecStage(Stage):
    """±1 layer ``y = sign(W @ x)`` via the tiled §II-B XNOR-popcount plan.

    The sign activation is the plan's native majority output, so the whole
    layer (dot products *and* nonlinearity) runs in-array; the host only
    tree-reduces tile partials when K spans several tiles. Set
    ``keep_popcounts=True`` on a final classifier layer and read
    ``last_popcounts`` for argmax scoring.
    """

    kind = "binary-matvec"

    def __init__(self, W: np.ndarray, name: Optional[str] = None,
                 keep_popcounts: bool = False, service=None, **plan_kw):
        M, K = W.shape
        self.W = W
        self.tiled = _fetch_tiled(service, "binary_matvec", M, K, **plan_kw)
        self.name = name or f"bmv_{M}x{K}"
        self.keep_popcounts = keep_popcounts
        self.last_popcounts: Optional[np.ndarray] = None

    def _run(self, x, backend, max_batch, faults, rng, prof, device):
        t = self.tiled
        y, info = t.run(self.W, x, backend=backend, max_batch=max_batch,
                        faults=faults, rng=rng, device=device)
        if self.keep_popcounts:
            self.last_popcounts = t.last_popcounts
        # boundary IO: write the x slice (1 row × tile_k data columns) into
        # each tile, read back the W-bit popcount field (tile_m rows)
        W_field = t.plan.W
        rep = self._report(
            prof, info.cycles, info.n_tiles, info.reduce_depth,
            t.energy(prof).total_fj * info.n_tiles,
            read_cols=W_field, write_cols=t.tile_k,
            read_cells=t.tile_m * W_field, write_cells=t.tile_k,
            backend=info.backend)
        return y, rep


class MatvecStage(Stage):
    """Full-precision ``y = A @ x mod 2^(2N)`` via the tiled §II-A plan."""

    kind = "matvec"

    def __init__(self, A: np.ndarray, N: int, name: Optional[str] = None,
                 service=None, **plan_kw):
        M, K = A.shape
        self.A, self.N = A, N
        self.tiled = _fetch_tiled(service, "matvec", M, K, N, **plan_kw)
        self.name = name or f"mv_{M}x{K}_N{N}"

    def _run(self, x, backend, max_batch, faults, rng, prof, device):
        t = self.tiled
        y, info = t.run(self.A, x, backend=backend, max_batch=max_batch,
                        faults=faults, rng=rng, device=device)
        W_field = t.plan.W
        rep = self._report(
            prof, info.cycles, info.n_tiles, info.reduce_depth,
            t.energy(prof).total_fj * info.n_tiles,
            read_cols=W_field, write_cols=t.tile_k * self.N,
            read_cells=t.tile_m * W_field, write_cells=t.tile_k * self.N,
            backend=info.backend)
        return y, rep


def decode_signed(out: np.ndarray, N: int) -> np.ndarray:
    """Two's-complement view of mod-2^N conv outputs (kernels with negative
    taps are encoded as 2^N − |k|; exact as long as |result| < 2^(N−1)).

    >>> decode_signed(np.array([3, 255, 128], dtype=object), 8)
    array([3, -1, -128], dtype=object)
    """
    half, full = 1 << (N - 1), 1 << N
    return np.where(np.asarray(out) >= half, np.asarray(out) - full, out)


class ConvStage(Stage):
    """Full-precision 2D correlation via the tiled §III-A/B plan.

    ``kernel`` may carry negative taps (encoded mod 2^N; outputs decode
    through :func:`decode_signed` when ``signed=True``). ``post`` is an
    optional host fixup applied to the decoded map (e.g. a blur
    normalization) — charged as free host work, like :class:`HostStage`.
    """

    kind = "conv"

    def __init__(self, kernel: np.ndarray, shape: Tuple[int, int], N: int,
                 signed: bool = True, post: Optional[Callable] = None,
                 name: Optional[str] = None, service=None, **tile_kw):
        self.kernel = np.asarray(kernel, dtype=np.int64)
        self.kmod = self.kernel % (1 << N)
        self.N, self.signed, self.post = N, signed, post
        H, Wd = shape
        k = self.kernel.shape[0]
        # conv programs specialize on the kernel: it joins the cache key so
        # stages with different kernels never share (and thrash) one plan
        self.tiled = _fetch_tiled(service, "conv", H, Wd, k, N,
                                  key_extra=self.kmod.tobytes(), **tile_kw)
        self.tiled.plan.ensure_program(self.kmod)
        self.name = name or f"conv{k}x{k}_{H}x{Wd}_N{N}"
        self.out_shape = (self.tiled.oh, self.tiled.ow)

    def _run(self, x, backend, max_batch, faults, rng, prof, device):
        t = self.tiled
        assert x.shape == (t.H, t.Wd), \
            f"{self.name}: got {x.shape}, wants {(t.H, t.Wd)}"
        out, info = t.run(np.asarray(x, dtype=np.int64) % (1 << self.N),
                          self.kmod, backend=backend, max_batch=max_batch,
                          faults=faults, rng=rng, device=device)
        if self.signed:
            out = decode_signed(out, self.N)
        if self.post is not None:
            out = self.post(out)
        p = t.plan
        # kernel-store columns are array-resident (weight-stationary) and
        # excluded: per-invocation IO covers the image and the result only
        in_cols = p.nin * self.N
        out_cols = p.nb * self.N
        rep = self._report(
            prof, info.cycles, info.n_tiles, info.reduce_depth,
            t.energy(prof).total_fj * info.n_tiles,
            read_cols=out_cols, write_cols=in_cols,
            read_cells=p.m_out * out_cols, write_cells=p.m * in_cols,
            backend=info.backend)
        return out, rep


class BinaryConvStage(Stage):
    """±1-kernel binary conv (§III-C): out = sign of the XNOR-tap majority."""

    kind = "binary-conv"

    def __init__(self, kernel: np.ndarray, shape: Tuple[int, int],
                 name: Optional[str] = None, service=None, **tile_kw):
        self.kernel = np.asarray(kernel, dtype=np.int64)
        assert set(np.unique(self.kernel)) <= {-1, 1}, "binary conv taps are ±1"
        H, Wd = shape
        k = self.kernel.shape[0]
        self.tiled = _fetch_tiled(service, "conv", H, Wd, k, 1, binary=True,
                                  key_extra=self.kernel.tobytes(), **tile_kw)
        self.tiled.plan.ensure_program(self.kernel)
        self.name = name or f"bconv{k}x{k}_{H}x{Wd}"
        self.out_shape = (self.tiled.oh, self.tiled.ow)

    def _run(self, x, backend, max_batch, faults, rng, prof, device):
        t = self.tiled
        assert x.shape == (t.H, t.Wd)
        out, info = t.run(x, self.kernel, backend=backend,
                          max_batch=max_batch, faults=faults, rng=rng,
                          device=device)
        p = t.plan
        in_cols = p.npp * p.P            # one bit-column per input column
        out_cols = p.nout_pp * p.P
        rep = self._report(
            prof, info.cycles, info.n_tiles, info.reduce_depth,
            t.energy(prof).total_fj * info.n_tiles,
            read_cols=out_cols, write_cols=in_cols,
            read_cells=p.m_out * out_cols, write_cells=p.m * in_cols,
            backend=info.backend)
        return out, rep


class HostStage(Stage):
    """Host-side elementwise fixup between crossbar stages (thresholds,
    rescales, binarization). Zero crossbar cycles/energy by definition — the
    point of the pipeline report is to make such host work *visible*, not to
    hide it inside an in-array charge it never pays.
    """

    kind = "host"

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray], name: str):
        self.fn = fn
        self.name = name

    def _run(self, x, backend, max_batch, faults, rng, prof, device):
        return self.fn(x), self._report(prof, 0, 0, 0, 0.0, 0, 0, 0, 0)


class ParallelStage(Stage):
    """Fan-out/fan-in: run N stages on the SAME input on disjoint tile grids
    and merge their outputs on the host (e.g. Sobel |Gx| + |Gy|).

    The branches occupy separate arrays with their own peripherals and
    execute/transfer concurrently, so *latency* (program cycles and IO
    cycles) is the max over branches, while *energy* and tile counts sum
    (each branch grid is written its own copy of the input and pays for it
    in cells moved).
    """

    kind = "parallel"

    def __init__(self, branches: Sequence[Stage],
                 merge: Callable[..., np.ndarray], name: str):
        self.branches = list(branches)
        self.merge = merge
        self.name = name

    def _run(self, x, backend, max_batch, faults, rng, prof, device):
        if faults is not None:
            rng = np.random.default_rng(rng)   # shared stream across branches
        outs, reps = [], []
        for b in self.branches:
            y, r = b.run(x, backend=backend, max_batch=max_batch,
                         faults=faults, rng=rng, profile=prof, device=device)
            outs.append(y)
            reps.append(r)
        # concurrent branches: the stage ends when the slowest branch's
        # program+IO finishes, so total = max(cycles + io) — the io_cycles
        # column reports whatever of that critical path is not program time
        cycles = max(r.cycles for r in reps)
        total = max(r.total_cycles for r in reps)
        rep = StageReport(
            name=self.name, kind=self.kind,
            cycles=cycles,
            io_cycles=total - cycles,
            n_tiles=sum(r.n_tiles for r in reps),
            reduce_depth=max(r.reduce_depth for r in reps),
            array_nj=sum(r.array_nj for r in reps),
            io_nj=sum(r.io_nj for r in reps),
            t_cycle_ns=prof.t_cycle_ns,
            backend="+".join(dict.fromkeys(r.backend for r in reps)))
        return self.merge(*outs), rep


class Pipeline:
    """A staged crossbar program: run stages in order, host boundary between
    each, one report for the whole workload."""

    def __init__(self, stages: Sequence[Stage], name: str = "pipeline"):
        self.stages = list(stages)
        self.name = name

    def run(self, x: np.ndarray, backend: str = "torch",
            max_batch: Optional[int] = None, faults=None, rng=None,
            profile=None, device="cuda"
            ) -> Tuple[np.ndarray, PipelineReport]:
        """Push ``x`` through every stage on ``device``; returns (output,
        report).

        ``faults``/``rng`` thread a stochastic device model through every
        crossbar stage — each stage's tiles draw independent realizations
        from one shared stream, the per-stage fault threading the
        Monte-Carlo sweeps in :mod:`repro_torch.apps.bnn` build on.
        """
        prof = get_profile(profile)
        if faults is not None:
            rng = np.random.default_rng(rng)
        reports: List[StageReport] = []
        for stage in self.stages:
            x, rep = stage.run(x, backend=backend, max_batch=max_batch,
                               faults=faults, rng=rng, profile=prof,
                               device=device)
            reports.append(rep)
        return x, PipelineReport(self.name, backend, prof.name, reports)


__all__ = [
    "BinaryConvStage", "BinaryMatvecStage", "ConvStage", "HostStage",
    "MatvecStage", "ParallelStage", "Pipeline", "PipelineReport", "Stage",
    "StageReport", "decode_signed", "majority_sign",
]
