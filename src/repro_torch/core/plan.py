"""Shared compile-then-execute base for the algorithm plans (port of
``src/repro/core/plan.py``).

A plan owns a crossbar geometry, a generated ``Program``, and the data
layout that maps operands into crossbar cells. :class:`CrossbarPlan` adds the
compiled-execution machinery on top:

    plan.compile()                          -> CompiledProgram (cached)
    plan.execute(mem, backend=, device=)    -> final memory, one crossbar
    plan.execute_batch(mems, ...)           -> EngineResult over B crossbars

``backend`` is ``"interp"`` (the host interpreter, ``Crossbar.run``, which
validates every cycle as it executes) or one of the engine backends
``"auto"``, ``"torch"``, ``"torch-fused"``, ``"torch-unfused"``,
``"kernels"`` (see ``engine.execute``), which run on ``device`` (``"cuda"``
by default).

The compile cache is invalidated whenever ``self.program`` is rebound.
The reference's ``energy()`` needs the device energy model
(``device/energy.py``), which is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .compile import CompiledProgram, compile_program, fuse_program
from .crossbar import Crossbar
from .engine import EngineResult, execute


class CrossbarPlan:
    """Mixin/base: subclasses set ``rows``, ``cols``, ``parts`` and
    ``self.program`` (a list of cycles) before calling the methods here.

    >>> from repro_torch.core import BinaryMatvecPlan
    >>> plan = BinaryMatvecPlan(2, 8, rows=16, cols=64, parts=2)
    >>> mem = np.zeros((16, 64), dtype=np.uint8)
    >>> plan.load_into(mem, np.ones((2, 8)), np.ones(8))
    >>> out, cycles, stats = plan.execute(mem, device="cpu")
    >>> cycles == plan.cycles == plan.compile().n_cycles
    True
    """

    rows: int
    cols: int
    parts: int
    program: Optional[list]

    _compiled: Optional[CompiledProgram] = None
    _compiled_src: Optional[list] = None

    # -- compilation ---------------------------------------------------------

    def compile(self, validate: bool = True,
                fuse: bool = True) -> CompiledProgram:
        prog = self.program
        assert prog is not None, "plan has no program built yet"
        if self._compiled is None or self._compiled_src is not prog:
            self._compiled = compile_program(
                prog, self.rows, self.cols, self.parts, self.parts,
                validate=validate, fuse=fuse)
            self._compiled_src = prog
            self._compiled.kernel_spec = self.kernel_spec()
        elif fuse and self._compiled.schedule is None:
            self._compiled.schedule = fuse_program(self._compiled)
        elif not fuse and self._compiled.schedule is not None:
            # honor the explicit request for an unfused trace without
            # clobbering the fused cache other callers rely on
            cp = compile_program(
                prog, self.rows, self.cols, self.parts, self.parts,
                validate=validate, fuse=False)
            cp.kernel_spec = self.kernel_spec()
            return cp
        return self._compiled

    def adopt_compiled(self, cp: CompiledProgram) -> CompiledProgram:
        """Install a deserialized trace as this plan's :meth:`compile` result.

        The restore half of ``core.compile.compiled_state`` (which accepts
        the reference's state too). Geometry must match the plan (a
        mismatched trace raises ``ValueError``); the kernel layout manifest
        is derived state, reattached here rather than serialized.
        """
        prog = self.program
        assert prog is not None, "plan has no program built yet"
        if (cp.rows, cp.cols) != (self.rows, self.cols):
            raise ValueError(
                f"compiled trace geometry {(cp.rows, cp.cols)} != plan "
                f"geometry {(self.rows, self.cols)}")
        cp.kernel_spec = self.kernel_spec()
        self._compiled = cp
        self._compiled_src = prog
        return cp

    def kernel_spec(self):
        """Layout manifest for the ``kernels`` backend, or ``None``.

        Plans whose algorithm a hand-written kernel computes override this
        (see ``core.kernel_exec``); the default keeps arbitrary programs on
        the replay backends.
        """
        return None

    @property
    def cycles(self) -> int:
        return len(self.program)

    def clear_caches(self) -> None:
        """Drop the compiled trace's executor memoizations (replay plans and
        their device tables). The compiled trace itself stays cached."""
        if self._compiled is not None:
            self._compiled.clear_caches()

    # -- execution -----------------------------------------------------------

    def new_crossbar(self) -> Crossbar:
        return Crossbar(self.rows, self.cols, self.parts, self.parts)

    @staticmethod
    def _run_interp(xb: Crossbar, program) -> Tuple[np.ndarray, int,
                                                     Dict[str, int]]:
        xb.cycles = 0
        xb.stats = {k: 0 for k in xb.stats}
        xb.run(program)
        return xb.mem, xb.cycles, dict(xb.stats)

    def execute(
        self,
        mem: np.ndarray,
        xbar: Optional[Crossbar] = None,
        backend: str = "torch",
        device="cuda",
        faults=None,
    ) -> Tuple[np.ndarray, int, Dict[str, int]]:
        """Run this plan's program over one crossbar image ``mem``.

        Returns (final mem, cycle count, stats). Passing ``xbar`` (or
        ``backend="interp"``) runs the host interpreter, replacing the
        crossbar's memory with ``mem`` and resetting its counters, so every
        call reports THIS run's accounting.
        """
        if xbar is not None or backend == "interp":
            self._reject_interp_faults(faults)
            xb = xbar or self.new_crossbar()
            xb.mem[:, :] = mem
            return self._run_interp(xb, self.program)
        res = execute(self.compile(), mem, backend=backend, device=device,
                      faults=faults)
        return res.mem, res.cycles, res.stats

    @staticmethod
    def _reject_interp_faults(faults) -> None:
        if faults is not None and not faults.is_ideal:
            raise ValueError("fault injection requires a compiled backend, "
                             "not the interpreter")

    def run_program(
        self,
        loader,
        xbar: Optional[Crossbar] = None,
        backend: str = "torch",
        device="cuda",
    ) -> Tuple[np.ndarray, int, Dict[str, int]]:
        """Shared ``run()`` body: load operands, execute, return final state.

        ``loader(mem)`` writes only the operand cells. With a caller-supplied
        ``xbar`` the loader applies to its EXISTING memory and the
        interpreter runs on it; otherwise a fresh zeroed image goes through
        the selected backend.
        """
        if xbar is not None:
            loader(xbar.mem)
            return self._run_interp(xbar, self.program)
        mem = np.zeros((self.rows, self.cols), dtype=np.uint8)
        loader(mem)
        return self.execute(mem, None, backend, device)

    def execute_batch(
        self,
        mems: np.ndarray,
        backend: str = "torch",
        device="cuda",
        max_batch: Optional[int] = None,
        faults=None,
        tunings=None,
    ) -> EngineResult:
        """Run this plan's program over ``(B, rows, cols)`` crossbars at once.

        ``backend="interp"`` loops the host interpreter over the batch
        (slow; useful for equivalence checks of batched/tiled paths).
        ``tunings`` is the table ``backend="auto"`` resolves from.
        """
        if backend == "interp":
            self._reject_interp_faults(faults)
            out = np.empty_like(mems)
            xb = self.new_crossbar()
            for b in range(mems.shape[0]):
                xb.mem[:, :] = mems[b]
                _, cycles, stats = self._run_interp(xb, self.program)
                out[b] = xb.mem
            return EngineResult(mem=out, cycles=cycles, stats=stats,
                                backend="interp")
        return execute(self.compile(), mems, backend=backend, device=device,
                       max_batch=max_batch, faults=faults, tunings=tunings)
