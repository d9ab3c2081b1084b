"""The program's own spans on the profiler's clock, and the device's idle
time put down to them.

The program records its spans with ``repro_torch.obs.trace`` on the host's
``perf_counter_ns``; ``torch.profiler`` stamps its events on a clock of its
own. :class:`ClockedTracer` is the harness's :class:`~bench.harness.Tracer`
that also reads ``perf_counter_ns`` just before and just after entering
each of its profiled spans (``bench.window`` and the ``bench.*`` spans in
it): the midpoint of the two reads that lie closest together is the
anchor, the instant the profiler stamped as that span's start, and half
their distance is the anchor's uncertainty. :func:`program_spans` maps the
program's spans onto the profiler's microseconds by it, and
:func:`idle_by_program` labels each idle gap of the device (the harness's
own ``union`` and ``gaps`` of the stretch's kernels) by the innermost
program span open when it began, or by the benchmark's span
(``harness.host_label``) outside every program span. The program's spans
never pass through ``torch.profiler.record_function``, which would put a
device copy of each among the kernels.

As a script, one serving cell's loop with the program's tracer on from the
window's start to the end of the traced stretch, on the card:

    python3 bench/program_trace.py --workload olmo-1b.rag --seed 7 --seconds 51

prints one JSON line: the window's tokens per second, ``decode_issue_ms``
(median host ms inside ``model.decode_step`` over the window's steps),
``host_copy_bytes_per_token`` (the window's ``engine.host_copy_bytes`` over
its ``engine.tokens``), the stretch's idle shares under ``model.*``,
``engine.*`` and no program span, ``idle_gaps_program``, the anchor's
uncertainty, how far any mapped ``engine.step`` or ``engine.admit`` sticks
out of its ``bench.step`` or ``bench.admit``, and the host's cost of one
span. It runs no correctness check: ``bench/run.py`` does.
"""
from __future__ import annotations

import bisect
import contextlib
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402

PREFIXES = ("model.", "engine.")     # the layers an idle gap is put down to


class ClockedTracer(harness.Tracer):
    """The harness's tracer, which also reads ``perf_counter_ns`` just
    before and just after entering each of its profiled spans
    (``bench.window`` and the benchmark's ``bench.*`` spans in it): the
    profiler stamped the span's start between the two reads. The pair
    closest together is the stretch's anchor (:meth:`anchor`). The spans
    themselves, and so ``summary()``, are the harness's. The stretch also
    runs on the CPU (no device to synchronise, the CPU's events alone)."""

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return self._marked(name)

    @contextlib.contextmanager
    def _marked(self, name: str):
        import torch
        rf = torch.profiler.record_function(name)   # built outside the reads
        before = time.perf_counter_ns()
        with rf:
            self.marks.append((name, before, time.perf_counter_ns()))
            yield

    @contextlib.contextmanager
    def stretch(self, device):
        import torch
        cuda = device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        # the first record_function of a process resolves its operator,
        # which would widen the first pair of reads: resolved here, where
        # no profiler records it
        with torch.profiler.record_function(self.WINDOW):
            pass
        self.marks = []
        with torch.profiler.profile(activities=acts) as prof:
            self.prof = prof
            with self._marked(self.WINDOW):
                yield
                if cuda:
                    torch.cuda.synchronize(device)
        self.prof = None
        self.events = prof.events()

    def anchor(self) -> Optional[Tuple[float, float, float]]:
        """``(anchor_ns, anchor_us, err_us)``: the host clock's ns and the
        profiler's µs of one instant, and the uncertainty, half the
        distance of the two reads around the span whose reads lie closest
        together. The ``k``-th mark of a name is the ``k``-th host event
        of that name in start order. ``None`` without a mark."""
        _, spans, window = profile_parts(self.events)
        starts: Dict[str, List[float]] = {}
        if window is not None:
            starts[self.WINDOW] = [window[0]]
        for (a, _), name in sorted(spans):
            starts.setdefault(name, []).append(a)
        seen: Dict[str, int] = {}
        best = None
        for name, before, after in self.marks:
            k = seen[name] = seen.get(name, -1) + 1
            at = starts.get(name, [])
            if k < len(at) and (best is None or after - before
                                < best[2] - best[1]):
                best = (at[k], before, after)
        if best is None:
            return None
        us, before, after = best
        return (before + after) / 2, us, (after - before) / 2e3


def profile_parts(events):
    """The profiler's events as ``harness.Tracer.summary`` splits them:
    kernels ``[((start, end), name)]``, the benchmark's host spans, and the
    ``bench.window`` interval (µs from the trace's start; ``None`` if
    absent)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, spans, window = [], [], None
    for e in events:
        tr = (e.time_range.start, e.time_range.end)
        if e.name.startswith("bench."):
            if e.device_type == cuda:
                continue
            if e.name == harness.Tracer.WINDOW:
                window = tr
            else:
                spans.append((tr, e.name))
        elif e.device_type == cuda:
            kernels.append((tr, e.name))
    return kernels, spans, window


def program_spans(events: Sequence[dict], t0_ns: int, anchor_ns: float,
                  anchor_us: float) -> List[tuple]:
    """The program tracer's events (Chrome-trace ``ts``/``dur`` in µs from
    its ``t0_ns``) as ``((start, end), name, args)`` in the profiler's µs,
    by an anchor that is ``anchor_ns`` on the host's clock and
    ``anchor_us`` on the profiler's:
    ``anchor_us + (t0_ns + ts * 1e3 - anchor_ns) / 1e3``."""
    out = []
    for e in events:
        a = anchor_us + (t0_ns + e["ts"] * 1e3 - anchor_ns) / 1e3
        out.append(((a, a + e["dur"]), e["name"], e["args"]))
    return out


def label_gaps(gaps: Sequence[Tuple[float, float]], prog: Sequence[tuple],
               spans: Sequence[tuple]) -> List[str]:
    """The label of each gap (sorted by start): the innermost program span
    open at its start, else ``harness.host_label`` of the benchmark's
    spans. One sweep: the program's spans of one thread nest, so the
    innermost open one is the top of a stack."""
    order = sorted(prog, key=lambda s: (s[0][0], -s[0][1]))
    stack: List[tuple] = []
    at, out = 0, []
    for a, _ in gaps:
        while at < len(order) and order[at][0][0] <= a:
            s = order[at]
            while stack and stack[-1][0][1] <= s[0][0]:
                stack.pop()
            stack.append(s)
            at += 1
        while stack and stack[-1][0][1] <= a:
            stack.pop()
        out.append(stack[-1][1] if stack else harness.host_label(spans, a))
    return out


def idle_by_program(tracer: ClockedTracer, events: Sequence[dict],
                    t0_ns: int, top: int = 10) -> dict:
    """The stretch's idle time put down to the program: ``idle_model_s``
    and ``idle_engine_s`` (the innermost program span ``model.*`` or
    ``engine.*``), ``idle_outside_s`` (no program span open), which sum to
    the idle time of ``tracer.summary()``; ``idle_gaps_program``, the
    ``top`` labels with the most idle time; and the anchor's uncertainty.
    Empty where the stretch ran no kernel."""
    kernels, spans, window = profile_parts(tracer.events)
    if window is None or not kernels:
        return {}
    busy = harness.union([(max(a, window[0]), min(z, window[1]))
                          for (a, z), _ in kernels if z > window[0]
                          and a < window[1]])
    anchor_ns, anchor_us, err_us = tracer.anchor()
    prog = [s for s in program_spans(events, t0_ns, anchor_ns, anchor_us)
            if s[0][1] > window[0] and s[0][0] < window[1]]
    gaps = list(harness.gaps(busy, window))
    idle: Dict[str, float] = {}
    for (a, z), label in zip(gaps, label_gaps(gaps, prog, spans)):
        idle[label] = idle.get(label, 0.0) + (z - a) / 1e6
    layer = {p: sum(s for n, s in idle.items() if n.startswith(p))
             for p in PREFIXES}
    return {"window_s": (window[1] - window[0]) / 1e6,
            "busy_s": sum(z - a for a, z in busy) / 1e6,
            "idle_model_s": layer["model."],
            "idle_engine_s": layer["engine."],
            "idle_outside_s": sum(idle.values()) - sum(layer.values()),
            "idle_gaps_program": sorted(idle.items(),
                                        key=lambda kv: -kv[1])[:top],
            "anchor_err_us": err_us,
            "sticks_out_us": sticks_out_us(prog, spans)}


def sticks_out_us(prog: Sequence[tuple], spans: Sequence[tuple]) -> \
        Optional[float]:
    """The most by which a mapped ``engine.step`` or ``engine.admit`` lies
    outside the benchmark's ``bench.step`` or ``bench.admit`` that overlaps
    it most, at either end, in µs (0 inside); ``None`` for no such span."""
    worst = None
    for (a, z), name, _ in prog:
        if name not in ("engine.step", "engine.admit"):
            continue
        kind = "bench." + name.split(".")[1]
        over = [(min(z, bz) - max(a, ba), ba, bz)
                for (ba, bz), bn in spans if bn == kind]
        if not over:
            continue
        _, ba, bz = max(over)
        out = max(ba - a, z - bz, 0.0)
        worst = out if worst is None else max(worst, out)
    return worst


def span_cost_ns(n: int = 100_000) -> float:
    """Host ns of one enabled ``span`` with one argument, entered and left,
    on a tracer of its own; tracing is off after it."""
    from repro_torch.obs import trace
    trace.enable(trace.Tracer())
    try:
        t = time.perf_counter_ns()
        for g in range(n):
            with trace.span("model.group", g=g):
                pass
        return (time.perf_counter_ns() - t) / n
    finally:
        trace.disable()


def spans_per_step(events: Sequence[dict]) -> Optional[float]:
    """Program spans a decode step records: those inside an
    ``engine.step`` (its own included), over the ``engine.step`` spans."""
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e["name"] == "engine.step")
    if not steps:
        return None
    starts = [a for a, _ in steps]
    inside = 0
    for e in events:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        inside += i >= 0 and e["ts"] + e["dur"] <= steps[i][1]
    return inside / len(steps)


def counters() -> Dict[str, float]:
    from repro_torch.obs import metrics
    return {n: metrics.counter(n).value
            for n in ("engine.tokens", "engine.host_copy_bytes")}


def serve_traced(cfg: dict, mix: dict, seed: int, seconds: float,
                 device) -> dict:
    """A serving mix's closed loop (``serve_closed_loop.Loop``) on
    ``device``: its ramp, a window of ``seconds`` with the program's
    tracer on, then the traced stretch; the readings of the module's
    docstring (those of the device trace only where kernels ran)."""
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.obs import trace
    from repro_torch.serve.engine import Engine

    from bench import traffic
    drv = harness.driver(mix["driver"])
    model = build_model(harness.model_config(cfg))
    params = harness.make_params(model.specs(), cfg["dtype"], seed, device)
    eng = Engine(model, params, max_batch=mix["max_batch"],
                 max_seq=mix["max_seq"])
    tracer = ClockedTracer()
    loop = drv.Loop(eng, traffic.requests(mix, cfg, seed), mix["clients"],
                    tracer)
    end = time.perf_counter() + mix["ramp_s"]
    while time.perf_counter() < end:
        loop.turn()
    n0 = len(loop.steps)
    c0, prog = counters(), trace.enable(trace.Tracer())
    w0 = time.perf_counter()
    while time.perf_counter() < w0 + seconds:
        loop.turn()
    w1 = time.perf_counter()
    c1, n1 = counters(), len(loop.steps)
    try:
        with tracer.stretch(device):
            for _ in range(mix["trace_iters"]):
                loop.turn()
    finally:
        trace.disable()
    # the window's spans, by the tracer's own clock (µs from its t0)
    w0_us, w1_us = ((w * 1e9 - prog.t0_ns) / 1e3 for w in (w0, w1))
    window = [e for e in prog.events()
              if w0_us <= e["ts"] and e["ts"] + e["dur"] <= w1_us]
    d = {n: c1[n] - c0[n] for n in c0}
    line = {
        "tokens_per_s": drv.window_records(loop.recs.values(), w0,
                                           w1)["tokens"] / (w1 - w0),
        "decode_steps": n1 - n0,
        "decode_issue_ms": harness.median(
            e["dur"] / 1e3 for e in window
            if e["name"] == "model.decode_step"),
        "decode_step_ms": harness.median(
            eng.timings()["decode_ms"][n0:n1]),
        "host_copy_bytes_per_token":
            d["engine.host_copy_bytes"] / d["engine.tokens"],
        "spans_per_decode_step": spans_per_step(window),
        "span_cost_ns": span_cost_ns(),
    }
    split = idle_by_program(tracer, prog.events(), prog.t0_ns)
    if split:
        summary = tracer.summary()
        share = lambda s: 100 * s / split["window_s"]    # noqa: E731
        line.update(
            device_idle_share=100 * (1 - summary["busy_s"]
                                     / summary["window_s"]),
            idle_share_model=share(split["idle_model_s"]),
            idle_share_engine=share(split["idle_engine_s"]),
            idle_share_outside=share(split["idle_outside_s"]),
            anchor_err_us=split["anchor_err_us"],
            sticks_out_us=split["sticks_out_us"],
            idle_gaps_program=split["idle_gaps_program"],
            idle_gaps=summary["idle_gaps"], window_s=split["window_s"],
            busy_s=split["busy_s"])
    if device.type == "cuda":
        line["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return line


def main(argv=None) -> int:
    import argparse
    import json

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = harness.cell(harness.benchmark(), args.workload)
    device = torch.device("cuda", 0)
    line = {"workload": args.workload, "seed": args.seed,
            "device": torch.cuda.get_device_name(device),
            "power_limit_w": harness.power_limit_w()}
    line.update(serve_traced(harness.config(cell["config"]),
                             harness.mix(cell["traffic"]),
                             args.seed % 2 ** 63, args.seconds, device))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
