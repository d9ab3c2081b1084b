"""Fill the PyTorch port's backend-autotuner table by timing real replays.

The counterpart of ``tools/autotune.py`` for ``src/repro_torch``: for each
workload in a small representative sweep (the plans the serving layer
buckets to, at the shapes it uses) and each batch bucket, time every
candidate backend of ``repro_torch.core.autotune.candidates`` on a real
``engine.execute`` replay and record the fastest into a ``TuningTable``
under the port's ``program_key`` and ``batch_bucket``.
``backend="auto"`` (``engine.execute`` and ``PlanService``) then serves
the measured winner for matching pairs instead of tuning them inline.

    python tools/autotune_torch.py --out results/torch_tunings.json
    python tools/autotune_torch.py --quick --device cpu   # small sweep
    MATPIM_TORCH_TUNINGS=results/torch_tunings.json python ...  # consumers

Runs on the card unless ``--device`` says otherwise. :func:`sweep` takes
any ``(name, plan, mems)`` list, so a caller can tune exactly the buckets
its own service will submit.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import BinaryMatvecPlan, MatvecPlan  # noqa: E402
from repro_torch.core.autotune import (CHUNK_BATCH, TuningEntry,  # noqa: E402
                                       TuningTable, autotune_execute,
                                       batch_bucket)
from repro_torch.core.conv import ConvPlan  # noqa: E402

BATCHES = [1, 8, 32, 64, 128]


def workloads(quick: bool) -> List[Tuple[str, object, Callable]]:
    """(name, plan, loader) triples covering the serving bucket shapes,
    the reference tool's four (two with ``quick``)."""
    rng = np.random.default_rng(0)
    if quick:
        geoms = dict(rows=256, cols=256, parts=8)
        shapes = [("binary_matvec", BinaryMatvecPlan(64, 64, **geoms)),
                  ("matvec", MatvecPlan(64, 8, 4, alpha=1, **geoms))]
    else:
        geoms = dict(rows=1024, cols=1024, parts=32)
        shapes = [
            ("binary_matvec", BinaryMatvecPlan(256, 128, **geoms)),
            ("binary_matvec", BinaryMatvecPlan(1024, 384, **geoms)),
            ("matvec", MatvecPlan(128, 16, 4, alpha=1, **geoms)),
            ("conv", ConvPlan(32, 32, 3, 4, **geoms)),
        ]
    out = []
    for name, plan in shapes:
        if isinstance(plan, BinaryMatvecPlan):
            A = rng.choice([-1, 1], size=(plan.m, plan.n))
            x = rng.choice([-1, 1], size=plan.n)

            def load(mem, plan=plan, A=A, x=x):
                plan.load_into(mem, A, x)
        elif isinstance(plan, MatvecPlan):
            A = rng.integers(0, 1 << plan.N, size=(plan.m, plan.n))
            x = rng.integers(0, 1 << plan.N, size=plan.n)

            def load(mem, plan=plan, A=A, x=x):
                plan.load_into(mem, A, x)
        else:
            A = rng.integers(0, 1 << plan.N, size=(plan.m, plan.n))
            K = rng.integers(0, 1 << plan.N, size=(plan.k, plan.k))
            plan.ensure_program(K)

            def load(mem, plan=plan, A=A, K=K):
                plan.load_into(mem, A, K)
        out.append((f"{name}_{plan.m}x{plan.n}", plan, load))
    return out


def batched(loaded: Iterable[Tuple[str, object, Callable]],
            batches: Iterable[int]):
    """``(name, plan, mems)`` for every workload at every batch width:
    the workload's one loaded image repeated ``B`` times."""
    for name, plan, load in loaded:
        mem = np.zeros((plan.rows, plan.cols), dtype=np.uint8)
        load(mem)
        for B in batches:
            yield name, plan, np.broadcast_to(mem, (B,) + mem.shape).copy()


def service_work(requests: Iterable[Tuple[str, tuple]], **service_kw
                 ) -> List[Tuple[str, object, np.ndarray]]:
    """``(name, plan, mems)`` for every bucket that one flush of
    ``requests`` (``(kind, args)`` pairs, submitted in order) executes on
    ``PlanService(**service_kw)``, ``backend="kernels"`` unless given: the
    input :func:`sweep` needs to tune exactly the buckets such a service
    submits. The flush runs for real; ``mems`` are its batches' images."""
    from repro_torch.serve import PlanService
    svc = PlanService(**{"backend": "kernels", "store": False,
                         **service_kw})
    work = []
    run = svc._execute_bucket

    def capture(plan, mems, faults, rng, device):
        work.append((f"{type(plan).__name__} {plan.m}x{plan.n}", plan,
                     np.array(mems)))
        return run(plan, mems, faults, rng, device)

    svc._execute_bucket = capture
    try:
        for kind, args in requests:
            svc.submit(kind, *args)
        svc.flush()
    finally:
        svc.close()
    return work


def sweep(work: Iterable[Tuple[str, object, np.ndarray]], table: TuningTable,
          device="cuda", reps: int = 3, cheap: bool = True,
          log: Optional[Callable[[str], None]] = print
          ) -> List[Tuple[str, int, TuningEntry]]:
    """Tune every ``(name, plan, mems)``: time each candidate on a real
    replay of ``mems`` (``(B, rows, cols)`` images) on ``device``, record
    the fastest in ``table`` under the plan's compiled program and the
    batch's bucket, and save the table. Returns ``(name, B, entry)`` per
    workload. ``cheap`` drops the per-cycle replay where a schedule exists,
    as the serving layer's inline tune does."""
    out = []
    for name, plan, mems in work:
        cp = plan.compile()
        B = mems.shape[0]
        _, entry = autotune_execute(cp, mems, table, reps=reps, cheap=cheap,
                                    save=False, device=device)
        out.append((name, B, entry))
        if log is not None:
            mb = f"@{entry.max_batch}" if entry.max_batch else ""
            log(f"{name:28s} B={B:4d} (bucket {batch_bucket(B):4d}) -> "
                f"{entry.backend}{mb}  {entry.us / 1e3:9.2f} ms")
    table.save()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_tunings.json",
                    help="tunings table path "
                         "(default results/torch_tunings.json)")
    ap.add_argument("--batches", type=int, nargs="*", default=BATCHES,
                    help="batch widths to tune (bucketed per packed word)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions per candidate (min is kept)")
    ap.add_argument("--quick", action="store_true",
                    help="small geometry + fewer shapes/batches (CI smoke)")
    ap.add_argument("--full-candidates", action="store_true",
                    help="include torch-unfused on fused traces (slow, "
                         "rarely wins)")
    ap.add_argument("--device", default="cuda",
                    help="device the replays run on (default cuda)")
    args = ap.parse_args(argv)
    if args.quick:
        args.batches = [b for b in args.batches if b <= CHUNK_BATCH * 2]

    table = TuningTable(args.out)
    t_start = time.perf_counter()
    sweep(batched(workloads(args.quick), args.batches), table,
          device=args.device, reps=args.reps,
          cheap=not args.full_candidates)
    keys = {k for k, _, _ in table.entries()}
    print(f"\nwrote {len(table)} entries ({len(keys)} program keys) to "
          f"{args.out} in {time.perf_counter() - t_start:.1f}s")
    print("consume with: MATPIM_TORCH_TUNINGS="
          f"{args.out} (engine backend='auto'), or "
          f"PlanService(backend='auto', tunings=TuningTable({args.out!r}))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
