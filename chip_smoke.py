"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``; imports nothing of JAX or of the reference package. Phases,
each printing one JSON line:

1. build   — compile every CUDA source of the port (one ``nvcc`` each, all
             started together) and print the build seconds and ptxas report.
2. kernels — every kernel against its plain PyTorch version on the card,
             exactly (tolerance 0: the outputs are integer popcounts, and
             the compared call's launch count is printed), at the main
             path's shape and at the reference's test
             shapes; kernel, plain and library (``torch.matmul`` of the
             unpacked ±1 operands, a yardstick the port never calls) times
             from CUDA events — per call, and for the kernel also per launch
             replayed from a CUDA graph, without the host — and the bound
             from bytes and operations.
3. engine  — ``BinaryMatvecPlan(1024, 416)`` (one tile of the main path) at
             B ∈ {1, 20, 33} on ``torch-fused``, ``torch-unfused`` and
             ``kernels``: all decode identically and equal numpy ``A @ x``;
             565 cycles. Wall times of the first run (which builds the
             replay tables) and of a second, warm run.
4. serve   — the main path: ``PlanService(device="cuda")`` at the paper's
             1024×1024 geometry on ``backend="kernels"`` and ``"torch"``,
             requests of 4096×2048, 1024×384 and 300×500, then ``flush()``.
             Launch counts are zeroed just before the kernels service runs
             and read just after. Tickets must equal ``sign(A @ x)``; the
             4096×2048 ticket shows 20 tiles, 565 cycles and reduce depth 3.

Then the per-kernel summary line ``{"kernels": [...]}``, the card's name
and power limit from ``nvidia-smi``, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero and prints no result line. Without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet rates: HBM bandwidth, and
# the 67 TFLOP/s non-tensor float32 rate, the data sheet's only rate for scalar
# 32-bit ALU work, applied to the kernel's integer XOR / popcount / add.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

RECORDS = []


def emit(phase: str, **kw) -> None:
    rec = {"phase": phase, **kw}
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, trials: int = 21, per_trial: int = 20) -> float:
    """Median over ``trials`` of CUDA-event time for ``per_trial``
    back-to-back calls, per call (warmed up first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_trial):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_trial)
    return float(np.median(times))


def graph_ms(torch, fn, trials: int = 21, per_graph: int = 20) -> float:
    """Device time per call with the host out of the way: ``per_graph``
    calls captured in one CUDA graph, median over ``trials`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(torch, graph.replay, trials=trials, per_trial=1) \
        / per_graph


def phase_build() -> None:
    from repro_torch import kernels
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = dict(zip(sources, pool.map(kernels.build, sources)))
    seconds = time.perf_counter() - t0
    for src in sources:
        kernels.load_library(src)
    emit("build", sources=sources, seconds=seconds,
         ptxas={s: [ln for ln in logs[s].splitlines() if "ptxas" in ln]
                for s in sources})


def binary_matmul_case(torch, B, M, N, Kw, seed):
    """Packed ±1 operands on the card, and their unpacked float32 form."""
    from repro_torch.kernels.ref import pack_bits
    rng = np.random.default_rng(seed)
    lead = (B,) if B else ()
    a = rng.choice([-1.0, 1.0], size=lead + (M, 32 * Kw)).astype(np.float32)
    b = rng.choice([-1.0, 1.0], size=lead + (N, 32 * Kw)).astype(np.float32)
    dev = torch.device("cuda")
    af, bf = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    return pack_bits(af), pack_bits(bf), af, bf


def phase_kernels(torch) -> dict:
    """binary_matmul vs binary_matmul_plain; returns the main-path row."""
    from repro_torch.kernels.binary_matmul import (binary_matmul,
                                                   binary_matmul_plain)
    # (B, M, N, Kw): the main path's shape first — 20 tiles of 1024 rows,
    # one 416-bit x per tile packed to 13 words — then the reference test
    # shapes (M, N, K) = (8, 8, 32), (128, 128, 256), (64, 256, 512)
    shapes = [(20, 1024, 1, 13), (0, 8, 8, 1), (0, 128, 128, 8),
              (0, 64, 256, 16)]
    rows = []
    for i, (B, M, N, Kw) in enumerate(shapes):
        ap, bp, af, bf = binary_matmul_case(torch, B, M, N, Kw, seed=i)
        binary_matmul.launches = 0
        got = binary_matmul(ap, bp)
        want = binary_matmul_plain(ap, bp)
        dense = torch.matmul(af, bf.transpose(-1, -2)).to(torch.int32)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0 and torch.equal(got, dense),
              f"binary_matmul != plain at {(B, M, N, Kw)}")
        nb = max(B, 1)
        nbytes = 4 * (ap.numel() + bp.numel() + got.numel())
        ops = nb * M * N * (3 * Kw + 1)   # xor, popc, add per word; epilogue
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        row = {
            "shape_BMNKw": [B, M, N, Kw], "max_abs_err": err,
            "tolerance": 0,               # integer popcounts: exact
            "launches": binary_matmul.launches,   # the compared call: 1
            "ms": cuda_ms(torch, lambda: binary_matmul(ap, bp)),
            "graph_ms": graph_ms(torch, lambda: binary_matmul(ap, bp)),
            "plain_ms": cuda_ms(torch, lambda: binary_matmul_plain(ap, bp)),
            "library_ms": cuda_ms(
                torch, lambda: torch.matmul(af, bf.transpose(-1, -2))),
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        emit("kernels", kernel="binary_matmul", **row)
        rows.append(row)
    main = dict(rows[0])
    main["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return main


def phase_engine() -> None:
    from repro_torch.core import BinaryMatvecPlan
    t0 = time.perf_counter()
    plan = BinaryMatvecPlan(1024, 416)
    cp = plan.compile()
    compile_s = time.perf_counter() - t0
    check(cp.n_cycles == 565, f"tile program has {cp.n_cycles} cycles")
    rng = np.random.default_rng(1)
    for B in (1, 20, 33):
        A = rng.choice([-1, 1], size=(B, 1024, 416))
        x = rng.choice([-1, 1], size=(B, 416))
        mems = np.zeros((B, 1024, 1024), np.uint8)
        for b in range(B):
            plan.load_into(mems[b], A[b], x[b])
        walls = {}
        decoded = {}
        for backend in ("torch-fused", "torch-unfused", "kernels"):
            for run in ("first", "warm"):
                t0 = time.perf_counter()
                res = plan.execute_batch(mems, backend=backend,
                                         device="cuda")
                walls[f"{backend}:{run}"] = (time.perf_counter() - t0) * 1e3
            check(res.backend == backend and res.cycles == 565,
                  f"{backend}: label {res.backend}, {res.cycles} cycles")
            decoded[backend] = (
                np.stack([plan.decode_y(m) for m in res.mem]),
                np.stack([plan.decode_popcount(m) for m in res.mem]))
        dots = np.einsum("bmk,bk->bm", A, x)
        for backend, (y, pop) in decoded.items():
            check(np.array_equal(y, np.where(dots >= 0, 1, -1)),
                  f"{backend} y != sign(A @ x) at B={B}")
            check(np.array_equal(pop, (dots + 416) // 2),
                  f"{backend} popcount != (A @ x + n) / 2 at B={B}")
        emit("engine", plan="BinaryMatvecPlan(1024, 416)", B=B, cycles=565,
             compile_s=compile_s, wall_ms=walls)


def serve_round(svc, reqs):
    from repro_torch.obs import trace
    tr = trace.enable()
    t0 = time.perf_counter()
    tickets = [svc.submit_binary_matvec(A, x) for A, x in reqs]
    svc.flush()
    wall = time.perf_counter() - t0
    trace.disable()
    spans = {}
    for ev in tr.events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    for t, (A, x) in zip(tickets, reqs):
        check(t.done and np.array_equal(t.result,
                                        np.where(A @ x >= 0, 1, -1)),
              f"ticket {t.uid} {A.shape} != sign(A @ x)")
    return tickets, wall, spans


def phase_serve(torch) -> int:
    """The main path; returns binary_matmul launches of the kernels run."""
    from repro_torch.kernels.binary_matmul import binary_matmul
    from repro_torch.serve import PlanService
    rng = np.random.default_rng(2)

    def requests():
        return [(rng.choice([-1, 1], size=(m, k)), rng.choice([-1, 1],
                                                              size=k))
                for m, k in ((4096, 2048), (1024, 384), (300, 500))]

    launches = None
    results = {}
    for backend in ("kernels", "torch"):
        svc = PlanService(backend=backend, device="cuda")
        reqs = requests()
        if backend == "kernels":
            binary_matmul.launches = 0
        tickets, wall, spans = serve_round(svc, reqs)
        if backend == "kernels":
            launches = binary_matmul.launches
            check(launches > 0, "the kernels service launched no kernel")
        big = tickets[0]
        check(big.n_units == 20 and big.cycles == 565
              and big.reduce_depth == 3,
              f"4096x2048: {big.n_units} tiles, {big.cycles} cycles, "
              f"depth {big.reduce_depth}")
        check(all(t.backend == backend for t in tickets),
              f"{backend} service labels {[t.backend for t in tickets]}")
        # a warm round: plans cached, replay tables and library loaded
        warm, warm_wall, warm_spans = serve_round(svc, requests())
        results[backend] = [t.result for t in tickets]
        emit("serve", backend=backend, launches=(
            launches if backend == "kernels" else None),
             stats=svc.stats.as_dict(),
             cold={"wall_s": wall, "spans_ms": spans, "requests": [
                 {"shape": list(A.shape), "tiles": t.n_units,
                  "cycles": t.cycles, "reduce_depth": t.reduce_depth,
                  "wall_s": t.wall_s, "batch_wall_s": t.batch_wall_s}
                 for t, (A, _) in zip(tickets, reqs)]},
             warm={"wall_s": warm_wall, "spans_ms": warm_spans,
                   "requests": [{"wall_s": t.wall_s,
                                 "batch_wall_s": t.batch_wall_s}
                                for t in warm]})
    return launches


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    check(bool(out), "nvidia-smi printed nothing")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every phase record here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    smi = nvidia_smi()
    phase_build()
    main_row = phase_kernels(torch)
    phase_engine()
    launches = phase_serve(torch)
    summary = {"kernels": [{
        "name": "binary_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/binary_matmul.cu",
        "replaces": "src/repro/kernels/binary_matmul.py:63",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"nvidia_smi": smi, "records": RECORDS, **summary}, indent=1))
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
