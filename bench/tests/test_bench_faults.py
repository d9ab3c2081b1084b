"""A run with the timed path broken underneath has to come out not
correct: each fault a cell can have, planted in the program, on the CPU
(the look for a card is skipped), against the cell's own limits.

* serving: a token altered where it is produced (``Engine._sample``), and
  a decode step that writes each new key and value row of the cache one
  position early (``layers._write_rows``), so that the row before it is
  lost and its own position reads whatever the slot held there;
* training: a step that returns its state unchanged, and a step fed half
  of its batch, the mean taken over that half.

The serving cells run at their published widths with two layers, so that
their logits have the size the limit was set at. As a script, the cache
fault is read on the card at the cell's own size, one line per seed:

    python3 bench/tests/test_bench_faults.py --workload <cell> \\
        --seeds 1 2 3 --seconds 25 [--layers N] [--out FILE.jsonl]

``--layers N`` plants it in the first ``N`` layers only (all by default).
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import time
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "bench" / "tests")]

from bench import harness  # noqa: E402

torch = pytest.importorskip("torch")


def cells(driver: str) -> list:
    """The cells of ``BENCHMARK.json`` whose mix runs ``driver``."""
    return [w["name"] for w in harness.benchmark()["workloads"]
            if harness.mix(w["traffic"])["driver"] == driver]


SERVING = cells("serve_closed_loop")
TRAINING = cells("train_steps")


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ctx_for(workload: str, config: dict, seconds: float = 0.5,
            **mix) -> dict:
    cell = harness.cell(harness.benchmark(), workload)
    cfg = dict(harness.config(cell["config"]), dtype="float32", **config)
    return {"config": cfg, "mix": dict(harness.mix(cell["traffic"]), **mix),
            "seed": 2 ** 31 + 17, "seconds": seconds, "trace": False,
            "device": torch.device("cpu"), "t0": time.perf_counter(),
            "limits": harness.limits(workload)}


def serving(workload: str) -> dict:
    return ctx_for(workload, {"n_layers": 2}, clients=2, max_batch=2,
                   max_seq=128, prompt_len=[32, 64], output_len=[8, 12],
                   ramp_s=0.2, check_requests=2, block=4, seconds=3.0)


@contextlib.contextmanager
def stale_rows(n_layers: int, layers: int = None):
    """The fault: in the first ``layers`` of ``n_layers`` layers (all by
    default), each decode step sets its new key and value rows at
    ``pos - 1`` instead of ``pos``."""
    from repro_torch.models import layers as L
    write, calls = L._write_rows, itertools.count()
    hit = n_layers if layers is None else layers

    def early(cache, pos, row):
        # attention_decode writes k then v, layer after layer
        if next(calls) // 2 % n_layers < hit:
            pos = (pos - 1).clamp(min=0)
        return write(cache, pos, row)
    with mock.patch.object(L, "_write_rows", early):
        yield


@pytest.mark.parametrize("workload", SERVING)
def test_an_altered_token_fails_the_serving_check(workload, monkeypatch):
    drv = harness.driver("serve_closed_loop")
    sound = drv.run(serving(workload))
    assert sound["correct"], sound["checks"]

    from repro_torch.serve.engine import Engine
    sample, calls = Engine._sample, itertools.count()

    def altered(self, logits):
        tok = sample(self, logits)
        return (tok + 1) % self.cfg.vocab if next(calls) % 5 == 2 else tok
    monkeypatch.setattr(Engine, "_sample", altered)
    broken = drv.run(serving(workload))
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("workload", SERVING)
def test_a_cache_row_written_early_fails_the_serving_check(workload):
    drv = harness.driver("serve_closed_loop")
    ctx = serving(workload)
    with stale_rows(ctx["config"]["n_layers"]):
        broken = drv.run(ctx)
    assert not broken["correct"], broken["checks"]


def training(workload: str) -> dict:
    return ctx_for(workload, dict(n_layers=2, d_model=64, n_heads=4,
                                         n_kv_heads=4, d_ff=128, vocab=512),
                   batch=4, seq=32)


def unchanged(step):
    """The fault: the step runs, and returns the state it was given."""
    def run(params, state, batch):
        return params, state, step(params, state, batch)[2]
    return run


@pytest.mark.parametrize("workload", TRAINING)
def test_training_faults_fail_the_training_check(workload):
    from test_bench_control import half_batch
    drv = harness.driver("train_steps")
    sound = drv.run(training(workload))
    assert sound["correct"], sound["checks"]
    for fault in (unchanged, half_batch):
        broken = drv.run(training(workload), fault=fault)
        assert not broken["correct"], (fault.__name__, broken["checks"])


def main(argv=None):
    from test_bench_control import context
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        ctx = context(args.workload, seed, args.seconds)
        drv = harness.driver(ctx["mix"]["driver"])
        with stale_rows(ctx["config"]["n_layers"], args.layers):
            rec = drv.run(ctx)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": "stale_rows", "layers": args.layers,
                           "requests": len(rec["sample"]),
                           "correct": rec["correct"],
                           "checks": rec["checks"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
