"""Closed-loop serving: ``clients`` clients against one ``Engine`` of the
program, each sending its next request the moment its last one completes.

The loop is the engine's own (``Engine.run``): admit every waiting
request that a free slot takes, one prefill at a time, then one decode step
of every live slot. It runs the mix's ``ramp_s`` seconds first, which warm
up every shape of the cell's traffic and bring the loop to its steady
state, and then the window. Host times are ``time.perf_counter``: a
request is sent at the host time its client's last token arrived, its
first token arrives when ``Engine.admit`` returns, and each later token
when the ``Engine.step`` that made it returns. The window ends at the end
of the first loop turn that ends ``seconds`` after it began.

Correctness: once the window has closed and the program is freed, a
sample of the requests finished in the window, drawn from the seed with
the longest among them, is run through the plain float32 reference once
each (prompt and served tokens), and ``gap_max`` is the widest gap by
which a served token's reference logit lies below the reference's best at
its position. Decoding is greedy, so a sound run serves the reference's
best up to rounding.
"""
from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List, Optional

import numpy as np

from bench import flops, harness, traffic

clock = time.perf_counter


class Loop:
    """The closed loop's state: the engine, the source of requests, every
    request's send time and token arrival times, and every loop turn's
    admissions and decode step."""

    def __init__(self, engine, source, clients: int, tracer):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.eng = engine
        self.source = source
        self.tracer = tracer
        self.recs: Dict[int, dict] = {}
        self.pending = collections.deque()
        self.steps: List[tuple] = []      # (t0, t1, tokens, context rows)
        self.admits: List[tuple] = []     # (uid, t0, t1)
        t = clock()
        for _ in range(clients):
            self.send(t)

    def send(self, t: float):
        prompt, n = next(self.source)
        uid = len(self.recs)
        self.recs[uid] = {"req": self.Request(uid=uid, prompt=prompt,
                                              max_new=n),
                          "sent": t, "times": [], "done": None}
        self.pending.append(uid)

    def turn(self):
        eng, span = self.eng, self.tracer.span
        while self.pending:
            rec = self.recs[self.pending[0]]
            with span("bench.admit"):
                t0 = clock()
                ok = eng.admit(rec["req"])
                t1 = clock()
            if not ok:
                break
            self.pending.popleft()
            rec["times"].append(t1)
            self.admits.append((rec["req"].uid, t0, t1))
        ctx = sum(int(eng.pos[i]) + 1 for i, r in enumerate(eng.slots)
                  if r is not None)
        with span("bench.step"):
            t0 = clock()
            out = eng.step()
            t1 = clock()
        if not out:
            return
        self.steps.append((t0, t1, len(out), ctx))
        for uid, _ in out:
            rec = self.recs[uid]
            rec["times"].append(t1)
            if rec["req"].done:
                rec["done"] = t1
                self.send(t1)


def run(ctx: dict) -> dict:
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import Engine
    cfg, mix, seed = ctx["config"], ctx["mix"], ctx["seed"]
    device = ctx["device"]
    on_card = device.type == "cuda"
    marks = [("imports", clock())]
    harness.cuda_ready(device)
    marks.append(("cuda", clock()))

    model = build_model(harness.model_config(cfg))
    specs = model.specs()
    params = harness.make_params(specs, cfg["dtype"], seed, device)
    harness.cuda_ready(device)
    marks.append(("weights", clock()))
    eng = Engine(model, params, max_batch=mix["max_batch"],
                 max_seq=mix["max_seq"])
    tracer = harness.Tracer()
    loop = Loop(eng, traffic.requests(mix, cfg, seed), mix["clients"],
                tracer)
    marks.append(("engine", clock()))
    end = clock() + mix["ramp_s"]
    while clock() < end:
        loop.turn()
    n_steps0, n_admits0 = len(loop.steps), len(loop.admits)
    w0 = clock()
    marks.append(("ramp", w0))
    while clock() < w0 + ctx["seconds"]:
        loop.turn()
    w1 = clock()
    steps = loop.steps[n_steps0:]
    admits = loop.admits[n_admits0:]
    rec = window_records(loop.recs.values(), w0, w1)
    rec.update(kind="serve", setup_s=w0 - ctx["t0"], window_s=w1 - w0,
               setup_parts=harness.setup_parts(ctx["t0"], marks),
               step_host_ms=[(t1 - t0) * 1e3 for t0, t1, _, _ in steps])
    rec["peak_flops"] = harness.PEAK_FLOPS[cfg["dtype"]]
    if ctx["trace"]:
        n_steps1, n_admits1 = len(loop.steps), len(loop.admits)
        with tracer.stretch(device):
            for _ in range(mix["trace_iters"]):
                loop.turn()
        rec["trace"] = tracer.summary()
        rec["trace_flops"] = work_flops(cfg, loop, loop.steps[n_steps1:],
                                        loop.admits[n_admits1:])
    if on_card:
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    t = eng.timings()
    rec["decode_ms"] = t["decode_ms"][n_steps0:n_steps0 + len(steps)]
    rec["prefill_ms"] = [t["prefill_ms"][u] for u, _, _ in admits]

    finished = [r for r in loop.recs.values()
                if r["done"] is not None and w0 < r["done"] <= w1]
    sample = pick(finished, mix["check_requests"], seed)
    del loop, eng, params, model, t
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    gaps = check(ctx, specs, sample)["gap"]
    limit = ctx["limits"]["gap_max"]
    # no request finished in the window: nothing to compare, not correct
    value = max(max(g) for g in gaps) if gaps else None
    rec["checks"] = {"gap_max": {"value": value, "limit": limit}}
    rec["correct"] = value is not None and value <= limit
    rec["sample"] = sample
    return rec


def work_flops(cfg: dict, loop: Loop, steps, admits) -> float:
    """Model flops of the useful work of some loop turns: each prompt
    prefilled, and each decode step over its slots' live contexts."""
    return (sum(flops.prefill(cfg, len(loop.recs[u]["req"].prompt))
                for u, _, _ in admits)
            + sum(flops.decode(cfg, n, c) for _, _, n, c in steps))


def window_records(recs, w0: float, w1: float) -> dict:
    """What the window saw: the tokens that arrived in it, the time to
    first token of every request whose first token arrived in it, every
    gap between two tokens of a request whose later token arrived in it,
    and the requests served in it."""
    inside = lambda t: w0 < t <= w1                      # noqa: E731
    tokens, ttft, itl, served = 0, [], [], 0
    for r in recs:
        times = r["times"]
        n = sum(1 for t in times if inside(t))
        tokens += n
        served += n > 0
        if times and inside(times[0]):
            ttft.append((times[0] - r["sent"]) * 1e3)
        itl += [(b - a) * 1e3 for a, b in zip(times, times[1:])
                if inside(b)]
    return {"tokens": tokens, "ttft_ms": ttft, "itl_ms": itl,
            "attempted": served, "failed": 0}


def pick(finished: List[dict], k: int, seed: int) -> List[dict]:
    """``k`` finished requests drawn from the seed, the longest (prompt and
    served tokens) among them: each as its prompt and its served tokens."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r["req"].prompt)
                                           + len(r["req"].out),
                                           -r["req"].uid))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng([int(seed), 1])
    idx = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    chosen = [longest] + [rest[i] for i in sorted(idx)]
    return [{"prompt": np.asarray(r["req"].prompt),
             "out": list(r["req"].out)} for r in chosen]


def check(ctx: dict, specs, sample: List[dict],
          control: Optional[callable] = None) -> dict:
    """Run the reference once over each sampled prompt and its served
    tokens: ``gap``, for each request, the gap below the reference's best
    logit of each served token; with ``control`` (a matrix product in a
    lower precision), also ``control_gap``, the same gap of the token that
    the reference computed with it puts first."""
    import torch
    cfg, device = ctx["config"], ctx["device"]
    ref = harness.reference(cfg["family"])
    params = harness.make_params(specs, cfg["dtype"], ctx["seed"], device)
    V = cfg["vocab"]
    out = {"gap": [], "control_gap": []}
    with torch.no_grad(), harness.float32_exact():
        for s in sample:
            prompt, served = s["prompt"], s["out"]
            toks = torch.as_tensor(np.concatenate(
                [prompt, np.asarray(served[:-1], np.int64)]), device=device)
            at = torch.arange(len(served), device=device)
            rows = ref.logits(cfg, params, toks)[len(prompt) - 1:, :V]
            best = rows.max(-1).values
            got = torch.as_tensor(served, device=device)
            out["gap"].append((best - rows[at, got]).tolist())
            if control is not None:
                low = ref.logits(cfg, params, toks, mm=control)
                first = low[len(prompt) - 1:, :V].argmax(-1)
                out["control_gap"].append((best - rows[at, first]).tolist())
    return out
