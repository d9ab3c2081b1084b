"""Training steps back to back: the program's ``make_train_step`` with
``make_optimizer``'s AdamW, on batches made on the device from the seed.

Set-up builds one training state (parameters from the seed, zero moments)
and drives it through the mix's ``checked_steps`` first steps by the same
call and feed as the window, each on rows of its own; what the check needs
of them is read as they pass: each step's loss, the norm of each leaf's
first gradient as the optimizer got it (its first moment after one step,
over ``1 - beta1``), and the norm of each leaf's change over those steps.
The window then takes the same state on, one step after another, the
device synchronised at the end of each, and ends at the end of the first
step that ends ``seconds`` after it began. CUDA events time each step,
with a mark between its gradients and its update (the pattern of
``launch/train.py::_StepMeter``).

Correctness: once the window has closed and the program is freed, the
plain float32 reference (``bench/reference/<family>.py``, with AdamW
written out here) takes the same weights and rows through the same first
steps. Its parameters are held in the configuration's dtype between steps,
as the program's are, and computed in float32 (TF32 off). Three numbers
are compared: ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap`` and ``change_gap``, over the leaves, the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose first gradient in
the reference is under a thousandth of the median leaf's move by
round-off alone under Adam, and are left out of ``change_gap``.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List

from bench import flops, harness, traffic

clock = time.perf_counter
QUIET = 1e-3      # a leaf's first gradient under this share of the median's


class StepMeter:
    """CUDA events at a step's start, at the mark between its gradients and
    its update, and at its end; with the tracer's spans around the two
    parts when a trace is on."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.events: List[list] = []

    def wrap(self, train_step: Callable) -> Callable:
        import torch

        def step(params, opt_state, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            spans = [self.tracer.span("bench.grad")]
            spans[0].__enter__()

            def mark():
                ev[1].record()
                spans[0].__exit__(None, None, None)
                spans.append(self.tracer.span("bench.update"))
                spans[1].__enter__()
            ev[0].record()
            out = train_step(params, opt_state, batch, mark=mark)
            ev[2].record()
            spans[-1].__exit__(None, None, None)
            self.events.append(ev)
            return out
        return step

    def read(self, start: int, stop: int) -> Dict[str, list]:
        import torch
        torch.cuda.synchronize()
        evs = self.events[start:stop]
        return {"step_ms": [a.elapsed_time(c) for a, _, c in evs],
                "grad_ms": [a.elapsed_time(b) for a, b, _ in evs],
                "update_ms": [b.elapsed_time(c) for _, b, c in evs]}


def leaves(tree, path=()) -> Dict[str, object]:
    """The tensors of a tree of dicts by their dotted path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], path + (k,)))
        return out
    return {".".join(path): tree}


def norms(tensors: Dict[str, object]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def train_config(mix: dict):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(microbatches=mix["microbatches"], remat=mix["remat"],
                       lr=mix["lr"], weight_decay=mix["weight_decay"],
                       beta1=mix["beta1"], beta2=mix["beta2"],
                       eps=mix["eps"],
                       opt_state_dtype=mix["opt_state_dtype"])


def run(ctx: dict, fault: Callable = None) -> dict:
    """``fault``, for tests of the check: a function of the program's
    ``(step, batch)`` that gives the ``(step, batch)`` to run instead."""
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.train.train_step import make_train_step
    cfg, mix, seed = ctx["config"], ctx["mix"], ctx["seed"]
    device = ctx["device"]
    on_card = device.type == "cuda"
    marks = [("imports", clock())]
    harness.cuda_ready(device)
    marks.append(("cuda", clock()))

    model = build_model(harness.model_config(cfg))
    train_step, opt = make_train_step(model, train_config(mix))
    specs = model.specs()
    params = harness.make_params(specs, cfg["dtype"], seed, device)
    state = opt.init(params)
    harness.cuda_ready(device)
    marks.append(("weights", clock()))
    feed = traffic.Batches(mix, cfg, seed, device)
    tracer = harness.Tracer()
    meter = StepMeter(tracer)
    step = meter.wrap(train_step) if on_card else train_step
    if fault is not None:
        step = fault(step)

    start = {k: t.clone() for k, t in leaves(params).items()}
    losses = []
    for i in range(mix["checked_steps"]):
        params, state, m = step(params, state, feed.next())
        losses.append(m["loss"])
        if i == 0:
            first = {k: dequantized(mu["m"]) for k, mu in
                     leaves_of_moments(state["mu"]).items()}
            grad = {k: v / (1 - mix["beta1"]) for k, v in
                    norms(first).items()}
            del first
    now = leaves(params)
    change = norms({k: now[k].float() - start[k].float() for k in start})
    losses = [float(x) for x in losses]
    del start, now

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    n0 = len(meter.events)
    n_steps = 0
    w0 = clock()
    marks.append(("checked_steps", w0))
    while True:
        params, state, _ = step(params, state, feed.next())
        sync()
        n_steps += 1
        w1 = clock()
        if w1 - w0 >= ctx["seconds"]:
            break
    B, S = mix["batch"], mix["seq"]
    rec = {"kind": "train", "setup_s": w0 - ctx["t0"], "window_s": w1 - w0,
           "setup_parts": harness.setup_parts(ctx["t0"], marks),
           "train_tokens": n_steps * B * S, "attempted": n_steps,
           "failed": 0, "step_flops": flops.train_step(cfg, B, S),
           "peak_flops": harness.PEAK_FLOPS[cfg["dtype"]]}
    if on_card:
        rec.update(meter.read(n0, n0 + n_steps))
    if ctx["trace"]:
        with tracer.stretch(device):
            for _ in range(mix["trace_steps"]):
                params, state, _ = step(params, state, feed.next())
        rec["trace"] = tracer.summary()
    if on_card:
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del params, state, step, train_step, opt, model, meter
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = reference_steps(ctx, specs)
    rec["readings"] = {"program": {"loss": losses, "grad": grad,
                                   "change": change}, "reference": ref}
    rec["checks"] = compare(losses, grad, change, ref, ctx["limits"])
    rec["correct"] = all(c["value"] <= c["limit"]
                         for c in rec["checks"].values())
    return rec


def dequantized(m):
    """A first moment as float32: int8 codes (``QTensor``) times their
    scales, where the program keeps int8 moments."""
    if isinstance(m, tuple):
        return m.q.float() * m.scale
    return m


def leaves_of_moments(mu) -> Dict[str, object]:
    """The moments ``{"m", "v"}`` of each parameter leaf, by its path."""
    if isinstance(mu, dict) and set(mu) == {"m", "v"}:
        return {"": mu}
    out = {}
    for k in sorted(mu):
        for p, v in leaves_of_moments(mu[k]).items():
            out[f"{k}.{p}" if p else k] = v
    return out


def reference_steps(ctx: dict, specs, mm=None) -> dict:
    """The reference's first ``checked_steps`` steps from the same weights
    and rows: each step's loss, each leaf's first gradient norm and its
    change over the steps. One row at a time through the reference's
    forward and backward, the gradients summed over the rows. ``mm``, the
    reference's product of every weight, is float32's unless a control
    gives a lower precision."""
    import torch
    cfg, mix, device = ctx["config"], ctx["mix"], ctx["device"]
    fam = harness.reference(cfg["family"])
    low = harness.make_params(specs, cfg["dtype"], ctx["seed"], device)
    p = {k: t.float().requires_grad_(True) for k, t in leaves(low).items()}
    store = {k: t.dtype for k, t in leaves(low).items()}
    del low
    start = {k: t.detach().clone() for k, t in p.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    feed = traffic.Batches(mix, cfg, ctx["seed"], device)
    losses, grad = [], None
    b1, b2 = mix["beta1"], mix["beta2"]
    with harness.float32_exact():
        for t in range(1, mix["checked_steps"] + 1):
            batch = feed.next()
            tree = unflatten(p)
            rows = batch["tokens"].shape[0]
            n_tok = batch["tokens"].numel()
            g = {k: torch.zeros_like(x) for k, x in p.items()}
            total = 0.0
            for r in range(rows):
                lg = fam.logits(cfg, tree, batch["tokens"][r],
                                mm=mm or fam.matmul)
                lse = torch.logsumexp(lg, dim=-1)
                gold = lg.gather(-1, batch["targets"][r][:, None])[:, 0]
                loss = (lse - gold).sum() / n_tok
                parts = torch.autograd.grad(loss, list(p.values()),
                                            allow_unused=True)
                for k, d in zip(p, parts):
                    if d is not None:
                        g[k] += d
                total += float(loss.detach())
                del lg, lse, gold, loss, parts
            losses.append(total)
            if grad is None:
                grad = {k: float(x.norm()) for k, x in g.items()}
            lr = lr_at(mix, t)
            with torch.no_grad():
                for k in p:
                    m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                    upd = (m[k] / (1 - b1 ** t)) / (
                        torch.sqrt(v[k] / (1 - b2 ** t)) + mix["eps"])
                    new = p[k] - lr * (upd + mix["weight_decay"] * p[k])
                    # held in the configuration's dtype between steps
                    p[k].copy_(new.to(store[k]).float())
            del g
    change = {k: float((p[k].detach() - start[k]).norm()) for k in p}
    return {"loss": losses, "grad": grad, "change": change}


def unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for k, t in flat.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = t
    return tree


def lr_at(mix: dict, t: int) -> float:
    """The learning rate of step ``t`` (counted from 1): a linear warm-up
    reaching the base rate at step ``warmup_steps - 1``, then a cosine over
    ``decay_steps`` (the program's schedule, stated in the mix)."""
    w, base = mix["warmup_steps"], mix["lr"]
    if t < w:
        return base * (t + 1) / w
    x = min((t - w) / mix["decay_steps"], 1.0)
    return base * 0.5 * (1 + math.cos(math.pi * x))


def compare(losses, grad, change, ref, limits) -> dict:
    """The three numbers compared, each beside its limit."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"]))
    med_g = harness.median(ref["grad"].values())
    grad_gap = max(abs(grad[k] - ref["grad"][k]) / max(ref["grad"][k], med_g)
                   for k in ref["grad"])
    moved = [k for k in ref["change"] if ref["grad"][k] >= QUIET * med_g]
    med_c = harness.median(ref["change"][k] for k in moved)
    change_gap = max(abs(change[k] - ref["change"][k])
                     / max(ref["change"][k], med_c) for k in moved)
    return {name: {"value": value, "limit": limits[name]}
            for name, value in (("loss_gap", loss_gap),
                                ("grad_gap", grad_gap),
                                ("change_gap", change_gap))}
