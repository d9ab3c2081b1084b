"""The readings that each cell's limits are set between, taken on the card
at the cell's own size. Marked ``cuda``: without a card these skip.

    python3 bench/tests/test_bench_control.py --workload <cell> \\
        --seeds 1 2 3 --seconds 25 [--out FILE.jsonl]

For a serving cell, each seed runs the cell's driver at the cell's own
load for a short window (long enough to finish the mix's longest
requests), and then reads, on the sample a run compares, the program's
``gap_max`` and the control's: the reference with every weight product in
float8 (``harness.fp8_matmul``), the gap of the token it puts first.

For a training cell, each seed reads the three numbers compared for the
program as the cell states it, for the control (the reference's steps
with every weight product in float8, against its float32 steps), and for
a fault (each step fed half of its batch, the mean taken over that
half).

    python3 -m pytest -q -m cuda bench/tests/test_bench_control.py
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402


def cells(driver: str) -> list:
    """The cells of ``BENCHMARK.json`` whose mix runs ``driver``."""
    return [w["name"] for w in harness.benchmark()["workloads"]
            if harness.mix(w["traffic"])["driver"] == driver]


SERVING = cells("serve_closed_loop")
TRAINING = cells("train_steps")


def context(workload: str, seed: int, seconds: float, **mix) -> dict:
    import torch
    cell = harness.cell(harness.benchmark(), workload)
    m = dict(harness.mix(cell["traffic"]), **mix)
    return {"config": harness.config(cell["config"]), "mix": m,
            "seed": seed, "seconds": seconds, "trace": False,
            "device": torch.device("cuda", 0), "t0": time.perf_counter(),
            "limits": harness.limits(workload)}


def serving_readings(workload: str, seed: int, seconds: float) -> dict:
    from repro_torch.models.lm import build_model
    ctx = context(workload, seed, seconds)
    drv = harness.driver(ctx["mix"]["driver"])
    rec = drv.run(ctx)
    specs = build_model(harness.model_config(ctx["config"])).specs()
    got = drv.check(ctx, specs, rec["sample"], control=harness.fp8_matmul)
    return {"workload": workload, "seed": seed,
            "tokens": sum(len(g) for g in got["gap"]),
            "program": max(max(g) for g in got["gap"]),
            "control": max(max(g) for g in got["control_gap"]),
            "limit": ctx["limits"]["gap_max"]}


def half_batch(step):
    """The fault: each step sees the first half of its rows only."""
    def run(params, state, batch):
        return step(params, state, {k: v[: v.shape[0] // 2]
                                    for k, v in batch.items()})
    return run


def training_readings(workload: str, seed: int, seconds: float) -> dict:
    from repro_torch.models.lm import build_model
    ctx = context(workload, seed, seconds)
    drv = harness.driver(ctx["mix"]["driver"])
    rec = drv.run(ctx)
    ref = rec["readings"]["reference"]
    specs = build_model(harness.model_config(ctx["config"])).specs()
    low = drv.reference_steps(ctx, specs, mm=harness.fp8_matmul)
    bad = drv.run(context(workload, seed, seconds), fault=half_batch)
    values = lambda checks: {k: c["value"] for k, c in checks.items()}  # noqa
    return {"workload": workload, "seed": seed,
            "program": values(rec["checks"]),
            "control": values(drv.compare(low["loss"], low["grad"],
                                          low["change"], ref, ctx["limits"])),
            "half_batch": values(bad["checks"]),
            "limits": ctx["limits"], "readings": rec["readings"],
            "control_readings": low}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SERVING)
def test_serving_control_fails_and_program_passes(cuda, workload):
    for seed in (101, 102, 103):
        r = serving_readings(workload, seed, 25.0)
        assert r["program"] <= r["limit"] < r["control"], r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAINING)
def test_training_control_and_fault_fail(cuda, workload):
    for seed in (101, 102, 103):
        r = training_readings(workload, seed, 1.0)
        lim = r["limits"]
        assert all(r["program"][k] <= lim[k] for k in lim), r
        for bad in ("control", "half_batch"):
            assert any(r[bad][k] > lim[k] for k in lim), (bad, r)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.cell(harness.benchmark(), args.workload)
    read = (training_readings
            if harness.mix(cell["traffic"])["driver"] == "train_steps"
            else serving_readings)
    for seed in args.seeds:
        r = read(args.workload, seed, args.seconds)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
