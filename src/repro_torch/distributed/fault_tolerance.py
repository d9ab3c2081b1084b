"""Fault tolerance, the port of ``src/repro/distributed/fault_tolerance.py``.

Components (all host-side control plane, with the reference's logic):

* ``HeartbeatMonitor`` — tracks per-host liveness; a missed deadline marks
  the host dead.
* ``StragglerDetector`` — per-step wall-time ring buffer; a step slower
  than ``threshold × median`` is flagged.
* ``ElasticScaler`` — on node loss, shrink the 'data' axis to the largest
  feasible mesh (TP groups stay intact).
* ``run_resilient_loop`` — the supervision wrapper used by
  ``launch/train.py``: try/except around the step, checkpoint cadence,
  simulated-failure hooks for tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class HeartbeatMonitor:
    hosts: List[str]
    timeout_s: float = 60.0

    def __post_init__(self):
        now = time.time()
        self.last_seen = {h: now for h in self.hosts}

    def beat(self, host: str, t: Optional[float] = None):
        self.last_seen[host] = t if t is not None else time.time()

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]


@dataclasses.dataclass
class StragglerDetector:
    window: int = 32
    threshold: float = 2.0

    def __post_init__(self):
        self.times: List[float] = []

    def record(self, step_time: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.times.append(step_time)
        self.times = self.times[-self.window:]
        if len(self.times) < 8:
            return False
        med = sorted(self.times)[len(self.times) // 2]
        return step_time > self.threshold * med


@dataclasses.dataclass
class ElasticScaler:
    """Chooses the next mesh after failures: shrink 'data', keep 'model'
    (TP groups must stay intact — a lost chip kills its TP group)."""
    data_axis: int
    model_axis: int

    def next_mesh_shape(self, chips_alive: int) -> Optional[Dict[str, int]]:
        d = self.data_axis
        while d > 0 and d * self.model_axis > chips_alive:
            d //= 2
        if d == 0:
            return None
        return {"data": d, "model": self.model_axis}


def run_resilient_loop(
    step_fn: Callable,
    state: Any,
    batch_at: Callable[[int], Any],
    checkpointer,
    n_steps: int,
    start_step: int = 0,
    ckpt_every: int = 50,
    fail_at: Optional[Dict[int, Exception]] = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
):
    """Supervised training loop: checkpoint cadence + restart-on-failure.

    ``state`` = (params, opt_state). ``fail_at`` injects failures for tests:
    {step: exception}. On failure: restore the latest checkpoint, take its
    step, resume (deterministic batches make this exact). With
    ``checkpointer=None`` nothing is saved and a failure propagates. The
    final state is saved at ``n_steps`` unless the cadence just saved it.

    On a mesh every rank runs the loop alike: an injected failure fires on
    every rank at its step, and the checkpointer's collective ``wait``,
    ``latest_step`` and ``restore`` bring every rank back to the same step,
    each leaf in its own placements.
    """
    straggler = StragglerDetector()
    # injection bookkeeping pops entries as they fire; work on a copy so a
    # caller reusing one fail_at config gets its failures re-injected on the
    # next run instead of a silent clean pass
    fail_at = dict(fail_at) if fail_at else fail_at
    step = start_step
    saved = None
    while step < n_steps:
        try:
            if fail_at and step in fail_at:
                e = fail_at.pop(step)
                raise e
            t0 = time.time()
            params, opt_state = state
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_at(step))
            state = (params, opt_state)
            dt = time.time() - t0
            if straggler.record(dt):
                # in production: flag host for replacement; here: log
                metrics = {**metrics, "straggler": True}
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if checkpointer is not None and step % ckpt_every == 0:
                checkpointer.save(step, state)
                saved = step
        except Exception:  # noqa: BLE001 — any failure: restore + resume
            if checkpointer is None:
                raise
            checkpointer.wait()
            last = checkpointer.latest_step()
            if last is None:
                raise
            state, manifest = checkpointer.restore(state, last)
            step = manifest["step"]
    if checkpointer is not None and saved == n_steps:
        checkpointer.wait()
    elif checkpointer is not None:
        checkpointer.save(n_steps, state, block=True)
    return state


__all__ = ["ElasticScaler", "HeartbeatMonitor", "StragglerDetector",
           "run_resilient_loop"]
