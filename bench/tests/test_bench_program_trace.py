"""The program's spans on the profiler's clock (``bench/program_trace.py``)
and the metric read from the program's counters: the anchor on a CPU
``torch.profiler`` run, the idle labels and shares on synthetic events,
the serving loop with the program traced at a small size on the CPU, and,
marked ``cuda``, the anchor and the mapped spans on the card.

    python3 -m pytest -q bench/tests/test_bench_program_trace.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness, program_trace  # noqa: E402

torch = pytest.importorskip("torch")

from repro_torch.obs import metrics, trace  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab=512)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    trace.disable()


def small_mix(trace_iters: int = 4) -> tuple:
    cfg = dict(harness.config("olmo-1b"), **SMALL, dtype="float32")
    mix = dict(harness.mix("chat"), clients=4, max_batch=4, max_seq=128,
               prompt_len=[16, 64], output_len=[4, 16], ramp_s=0.2,
               block=8, trace_iters=trace_iters)
    return cfg, mix


def test_a_program_span_maps_inside_its_bench_span_on_a_cpu_profile():
    tracer = program_trace.ClockedTracer()
    prog = trace.enable(trace.Tracer())
    with tracer.stretch(torch.device("cpu")):
        with tracer.span("bench.step"):
            time.sleep(0.002)
            with trace.span("engine.step", live=1):
                torch.ones(64).sum()
                time.sleep(0.001)
            time.sleep(0.002)
    trace.disable()
    assert [m[0] for m in tracer.marks] == ["bench.window", "bench.step"]
    anchor_ns, anchor_us, err_us = tracer.anchor()
    assert 0 <= err_us < 1000
    _, spans, _ = program_trace.profile_parts(tracer.events)
    mapped = program_trace.program_spans(prog.events(), prog.t0_ns,
                                         anchor_ns, anchor_us)
    ((a, z), name, args), = mapped
    (ba, bz), = [tr for tr, n in spans if n == "bench.step"]
    assert name == "engine.step" and args["live"] == 1
    assert ba < a < z < bz
    # at least the 2 ms slept on either side, up to the anchor's error: a
    # shift of the mapping either way would eat into one of them
    slack = err_us + 50
    assert a - ba >= 2000 - slack and bz - z >= 2000 - slack
    assert program_trace.sticks_out_us(mapped, spans) == 0.0


def event(name, a, z, cuda=False):
    dev = (torch.autograd.DeviceType.CUDA if cuda
           else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=z))


def synthetic():
    """A stretch 0-100 µs: kernels 10-20, 40-50, 70-80 (idle 70 µs);
    bench.step 0-60, bench.admit 60-95; program spans engine.step 5-55 with
    model.decode_step 8-35 and engine.step.fetch 35-50, engine.admit
    62-90, and an engine.step before the stretch."""
    tracer = program_trace.ClockedTracer()
    tracer.events = [
        event("bench.window", 0, 100), event("bench.window", 0, 100, True),
        event("bench.step", 0, 60), event("bench.admit", 60, 95),
        event("bench.step", 0, 1, True),
        event("k0", 10, 20, True), event("k1", 40, 50, True),
        event("k2", 70, 80, True), event("cpu_op", 30, 31)]
    # the window's reads 1 µs apart around 1 ms on the host's clock; the
    # step's 3 µs apart: the window's start (0 µs) is the anchor
    tracer.marks = [("bench.window", 999_500, 1_000_500),
                    ("bench.step", 999_000, 1_002_000)]
    t0 = 1_000_000 - 5_000          # the program tracer's t0: 5 µs before
    prog = [{"name": n, "ts": a + 5, "dur": z - a, "args": {}}
            for n, a, z in [("engine.step", -500, -450),   # before it
                            ("engine.step", 5, 55),
                            ("model.decode_step", 8, 35),
                            ("engine.step.fetch", 35, 50),
                            ("engine.admit", 62, 90)]]
    return tracer, prog, t0


def test_idle_gaps_fall_back_to_bench_labels_outside_program_spans():
    tracer, prog, t0 = synthetic()
    split = program_trace.idle_by_program(tracer, prog, t0)
    # gaps by their start: 0-10 bench.step, 20-40 model.decode_step,
    # 50-70 engine.step (open to 55), 80-100 engine.admit
    assert dict(split["idle_gaps_program"]) == pytest.approx(
        {"bench.step": 10e-6, "model.decode_step": 20e-6,
         "engine.step": 20e-6, "engine.admit": 20e-6})
    spans = [((0, 60), "bench.step"), ((60, 95), "bench.admit")]
    assert tracer.anchor() == (1_000_000, 0, 0.5)
    assert split["anchor_err_us"] == 0.5
    assert split["sticks_out_us"] == 0.0       # the stretch's spans only
    mapped = program_trace.program_spans(prog, t0, 1_000_000, 0)
    assert mapped[0][0] == (-500, -450)
    assert program_trace.label_gaps([(0, 1), (36, 37), (56, 57), (96, 97)],
                                    mapped, spans) == [
        "bench.step", "engine.step.fetch", "bench.step", "bench.other"]
    assert program_trace.sticks_out_us(mapped[1:], spans) == 0.0
    late = [((58, 63), "engine.step", {})]      # 3 µs past its bench.step
    assert program_trace.sticks_out_us(late, spans) == 3


def test_idle_shares_add_up_to_the_device_idle_share():
    tracer, prog, t0 = synthetic()
    split = program_trace.idle_by_program(tracer, prog, t0)
    summary = tracer.summary()
    assert (split["busy_s"], split["window_s"]) == (summary["busy_s"],
                                                    summary["window_s"])
    idle = harness.metric("device_idle_share.serve").read(
        {"kind": "serve", "trace": summary})
    parts = [100 * split[k] / split["window_s"] for k in
             ("idle_model_s", "idle_engine_s", "idle_outside_s")]
    assert parts == pytest.approx([20.0, 40.0, 10.0])
    assert sum(parts) == pytest.approx(idle, abs=1e-9)
    # the benchmark's own reduction is the parent's: bench labels only
    assert dict(summary["idle_gaps"]) == pytest.approx(
        {"bench.step": 50e-6, "bench.admit": 20e-6})


def test_host_copy_bytes_per_token_reads_the_programs_counters():
    read = harness.metric("host_copy_bytes_per_token").read
    metrics.reset_metrics()
    assert read({"kind": "serve"}) is None       # a program without them
    metrics.counter("engine.tokens").inc(4)
    metrics.counter("engine.host_copy_bytes").inc(4 * 201_216)
    assert read({"kind": "serve"}) == 201_216
    assert read({"kind": "train"}) is None
    metrics.reset_metrics()


def test_the_serving_loop_traced_on_the_cpu():
    """Every slot live in a closed loop: one float32 logits row a token;
    a decode step records its own span, the model's, one per layer group,
    the fetch and the sampling."""
    cfg, mix = small_mix()
    got = program_trace.serve_traced(cfg, mix, 2 ** 31 + 9, 0.5,
                                     torch.device("cpu"))
    assert got["host_copy_bytes_per_token"] == cfg["vocab"] * 4
    assert got["spans_per_decode_step"] == 4 + cfg["n_layers"]
    assert got["decode_steps"] > 0 and got["decode_issue_ms"] > 0
    assert got["tokens_per_s"] > 0 and 0 < got["span_cost_ns"] < 1e6
    assert "idle_gaps_program" not in got        # no kernel on the CPU
    assert not trace.enabled()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_the_anchor_and_the_mapped_spans_on_the_card(cuda):
    cfg, mix = small_mix(trace_iters=24)
    got = program_trace.serve_traced(cfg, mix, 2 ** 31 + 9, 2.0,
                                     torch.device("cuda", 0))
    assert got["anchor_err_us"] <= 20, got
    assert got["sticks_out_us"] <= 50, got
    parts = sum(got[k] for k in ("idle_share_model", "idle_share_engine",
                                 "idle_share_outside"))
    assert parts == pytest.approx(got["device_idle_share"], abs=0.01)
