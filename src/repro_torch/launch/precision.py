"""Float32 drift against float64, layer group by layer group.

    PYTHONPATH=src python -m repro_torch.launch.precision --arch mamba2-370m \\
        [--device cuda|cpu] [--smoke] [--tf32] [--out FILE]

A decoder-only config (dense, moe, ssm or hybrid) at full width
(``--smoke``: reduced), in float32 on weights drawn from a CPU
``torch.Generator`` (seed 1), runs one 16-token prompt on the CPU and on
``--device``; the same weights widened to float64 run on the CPU as the
reference (:func:`f64_reference`: the model built with ``dtype="float64"``,
so every layer computes in float64, :func:`repro_torch.models.spec.wide`).
For each layer group ``g`` the report gives, as shares of the float64
hidden state's largest magnitude after the group:

* ``acc``: how far the float32 hidden state after the group is from the
  float64 one (the drift so far);
* ``local``: the rounding the group adds alone: the group in float32 on the
  float64 input, against the group in float64;
* ``carried``: the drift the group carries forward with no rounding of its
  own: the group in float64 on the float32 run's input; ``gain`` is how
  much it grew the incoming drift (``carried`` over the incoming ``acc``,
  in absolute terms).

For the group where ``--device`` drifts most beyond the CPU, ``ops`` lists
the torch calls inside it whose float32 output (on the float64 input) is
furthest from float64 on the device, beside the CPU's reading for the same
call, and ``first`` the earliest call where the device is off by more than
three times the CPU and 1e-6. ``--tf32`` lets cuBLAS and cuDNN use TF32 on
the device: a control, the precision loss a check of float32 must reject.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..core.engine import resolve_device
from ..models import layers as L
from ..models.lm import Model, _group, build_model
from ..models.spec import init_params, tree_map

FAMILIES = ("dense", "moe", "ssm", "hybrid")
TOP_OPS = 8     # calls listed for the group that drifts most on the device


def seeded_f32(arch: str, smoke: bool = False):
    """``(cfg, model, params)``: the config in float32 and its weights from
    a CPU generator seeded with 1, on the CPU."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    params = init_params(model.specs(), torch.Generator().manual_seed(1),
                         "float32")
    return cfg, model, params


def prompt(cfg, n: int) -> torch.Tensor:
    """One prompt of ``n`` tokens from numpy seed 4, shape (1, n)."""
    return torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab, (1, n))).long()


def f64_reference(cfg, params, toks, steps: int):
    """The model in float64 on the CPU, on ``params`` widened: the forward
    logits, and the largest difference between the first ``steps`` decode
    steps and the forward (the two paths' arithmetic, free of float32
    rounding)."""
    model = build_model(dataclasses.replace(cfg, dtype="float64"))
    wide = tree_map(lambda t: t.double(), params)
    toks = toks.cpu()
    with torch.no_grad():
        full = model.forward(wide, {"tokens": toks})[0]
        cache = model.init_cache(toks.shape[0], steps, torch.float64,
                                 device="cpu")
        err = 0.0
        for t in range(steps):
            lg, cache = model.decode_step(wide, cache, toks[:, t:t + 1],
                                          torch.full((toks.shape[0],), t))
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    return full, err


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN on (the control) or off, restored after."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = on
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def _group_fn(model: Model, params, g: int, pos):
    lp = _group(params["layers"], g)

    def run(x):
        for i, kind in enumerate(model.kinds):
            x, _ = model._apply_sublayer(lp[f"sub{i}"], kind, x, pos, None)
        return x
    return run


def _hiddens(model: Model, params, toks) -> List[torch.Tensor]:
    """The embedding and the hidden state after each layer group."""
    pos = model._positions(*toks.shape, toks.device)
    xs = [L.embed(params["embed"], model.cfg, toks)]
    for g in range(model.n_groups):
        xs.append(_group_fn(model, params, g, pos)(xs[-1]))
    return xs


class _Calls(torch.overrides.TorchFunctionMode):
    """Every floating tensor a torch call returns, in call order."""

    def __init__(self):
        super().__init__()
        self.out = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        r = func(*args, **(kwargs or {}))
        if isinstance(r, torch.Tensor) and r.is_floating_point():
            self.out.append((getattr(func, "__name__", str(func)),
                             r.detach()))
        return r


def _calls(fn, x):
    with _Calls() as rec:
        fn(x)
    return rec.out


def _share(a, b, scale: float) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max()) / scale


def layer_drift(arch: str, device="cuda", smoke: bool = False,
                n_prompt: int = 16, control: bool = False) -> dict:
    """The report the module docstring describes, as a dict."""
    dev = resolve_device(device)
    cfg, model, params = seeded_f32(arch, smoke)
    if cfg.family not in FAMILIES:
        raise ValueError(f"{arch}: family {cfg.family!r} is not "
                         f"decoder-only ({', '.join(FAMILIES)})")
    toks = prompt(cfg, n_prompt)
    m64 = build_model(dataclasses.replace(cfg, dtype="float64"))
    p64 = tree_map(lambda t: t.double(), params)
    pd = tree_map(lambda t: t.to(dev), params)
    pos_c = model._positions(*toks.shape, toks.device)
    pos_d = pos_c.to(dev)
    rows, ops = [], None
    with torch.no_grad(), tf32(control):
        h64 = _hiddens(m64, p64, toks)
        runs = {"cpu": _hiddens(model, params, toks),
                "dev": _hiddens(model, pd, toks.to(dev))}
        worst, worst_g = 0.0, None
        for g in range(model.n_groups):
            s = max(1.0, float(h64[g + 1].abs().max()))
            s_in = max(1.0, float(h64[g].abs().max()))
            f64 = _group_fn(m64, p64, g, pos_c)
            row = {"group": g, "scale": s}
            for name, hs, p, pos, d in (("cpu", runs["cpu"], params, pos_c,
                                         "cpu"),
                                        ("dev", runs["dev"], pd, pos_d, dev)):
                f32 = _group_fn(model, p, g, pos)
                acc_in = _share(hs[g], h64[g], s_in) * s_in
                carried = _share(f64(hs[g].double().cpu()), h64[g + 1], s)
                row[name] = {
                    "acc": _share(hs[g + 1], h64[g + 1], s),
                    "local": _share(f32(h64[g].float().to(d)), h64[g + 1],
                                    s),
                    "carried": carried,
                    "gain": carried * s / acc_in if acc_in else None}
            rows.append(row)
            excess = row["dev"]["local"] - row["cpu"]["local"]
            if worst_g is None or excess > worst:
                worst, worst_g = excess, g
        if worst_g is not None:
            x64 = h64[worst_g]
            ref = _calls(_group_fn(m64, p64, worst_g, pos_c), x64)
            cpu = _calls(_group_fn(model, params, worst_g, pos_c),
                         x64.float())
            on = _calls(_group_fn(model, pd, worst_g, pos_d),
                        x64.float().to(dev))
            found = []
            for i, ((name, r), (_, c), (_, d)) in enumerate(
                    zip(ref, cpu, on)):
                if r.shape != d.shape or not r.numel():
                    continue
                sc = max(1.0, float(r.abs().max()))
                found.append({"call": i, "op": name,
                              "shape": list(r.shape),
                              "dev": _share(d, r, sc),
                              "cpu": _share(c, r, sc)})
            first = next((o for o in found if o["dev"] > 1e-6
                          and o["dev"] > 3 * o["cpu"]), None)
            found.sort(key=lambda o: o["dev"] - o["cpu"], reverse=True)
            ops = {"group": worst_g, "calls": len(ref), "first": first,
                   "top": found[:TOP_OPS]}
        logits = {}
        for name, hs, p in (("cpu", runs["cpu"], params),
                            ("dev", runs["dev"], pd),
                            ("f64", h64, p64)):
            m = m64 if name == "f64" else model
            x = L.apply_norm(p["final_norm"], m.cfg, hs[-1])
            logits[name] = L.unembed(p["embed"], m.cfg, x)
    scale = max(1.0, float(logits["f64"].abs().max()))
    return {"arch": arch, "device": str(dev), "tf32": control,
            "layers": cfg.n_layers, "groups": model.n_groups,
            "prompt": n_prompt, "logits_scale": scale,
            "logits": {k: _share(logits[k], logits["f64"], scale)
                       for k in ("cpu", "dev")},
            "rows": rows, "ops": ops}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    rep = layer_drift(a.arch, a.device, a.smoke, control=a.tf32)
    print(f"{a.arch} {rep['device']} tf32={a.tf32}: logits off float64 by "
          f"{rep['logits']['dev']:.3g} ({rep['device']}) and "
          f"{rep['logits']['cpu']:.3g} (cpu) of {rep['logits_scale']:.4g}")
    print("group     acc dev/cpu        local dev/cpu      gain dev/cpu")
    for r in rep["rows"]:
        d, c = r["dev"], r["cpu"]
        print(f"{r['group']:5d}  {d['acc']:.2e}/{c['acc']:.2e}  "
              f"{d['local']:.2e}/{c['local']:.2e}  "
              f"{d['gain'] or 0:.3g}/{c['gain'] or 0:.3g}")
    if rep["ops"]:
        print(f"group {rep['ops']['group']}, calls furthest from float64 "
              f"on {rep['device']} beyond the cpu:")
        first = rep["ops"]["first"]
        for o in ([first] if first else []) + rep["ops"]["top"]:
            print(f"  #{o['call']} {o['op']} {o['shape']}: "
                  f"{o['dev']:.2e} / cpu {o['cpu']:.2e}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
