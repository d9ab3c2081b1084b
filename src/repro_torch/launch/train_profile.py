"""Where a train step's time and memory go on the card.

    PYTHONPATH=src python -m repro_torch.launch.train_profile \\
        --arch olmo-1b [--batch 8] [--seq 256] [--remat none] \\
        [--opt-dtype float32] [--microbatches 1] [--out FILE]

The config at full width in its dtype, weights from a ``torch.Generator``
seeded with 0 on the card, ``SyntheticLM`` batch 0. After two warm steps:

* ``profile``: one step under ``torch.profiler`` (CPU and CUDA
  activities): its host wall (ending in a device sync), the device's busy
  time (the union of the kernels' intervals), the idle share
  (``1 - busy / wall``), the kernel count and the operators with the most
  device time;
* ``memory``: one step under ``torch.cuda.memory._record_memory_history``:
  the bytes resident before it, and for its gradients (with their norm)
  and its optimizer update apiece, the peak of what that part allocated
  and which source lines of the package held it at that peak.

Needs a card: without CUDA it raises (``device="cpu"`` has no device time
to read).
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import torch

from ..configs import TrainConfig, get_config
from ..core.engine import resolve_device
from ..data.pipeline import SyntheticLM, make_global_batch
from ..models.lm import build_model
from ..models.spec import init_params
from ..train.train_step import make_train_step
from .mesh import make_local_mesh

TOP = 15        # operators and source lines listed


def busy_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals in µs, in ms.

    >>> busy_ms([(0, 10), (5, 20), (30, 40)])
    0.03
    """
    total, cur = 0.0, None
    for a, z in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, z]
        else:
            cur[1] = max(cur[1], z)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def peak_sites(events: List[dict], top: int = TOP) -> dict:
    """Replay a memory history's ``alloc``/``free_completed`` events: the
    peak of the bytes allocated in the window and still live, and those
    bytes by the innermost three frames of this package that allocated
    them (``"?"``: allocated with no Python frame, as autograd's
    gradients are)."""
    live, total, best, at_best = {}, 0, 0, {}
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            total += e["size"]
            if total > best:
                best, at_best = total, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])["size"]
    sites = collections.Counter()
    for e in at_best.values():
        frames = [f for f in e.get("frames", [])
                  if "repro_torch" in f["filename"]]
        sites[" < ".join(f"{Path(f['filename']).name}:{f['line']}"
                         f":{f['name']}" for f in frames[:3]) or "?"] += \
            e["size"]
    return {"peak_bytes": best, "sites": sites.most_common(top)}


def profile_step(arch: str = "olmo-1b", batch: int = 8, seq: int = 256,
                 remat: str = "none", opt_dtype: str = "float32",
                 microbatches: int = 1, device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("train_profile reads device time: it needs CUDA")
    cfg = get_config(arch)
    mesh = make_local_mesh(dev)
    model = build_model(cfg)
    step, opt = make_train_step(model, TrainConfig(
        lr=1e-3, remat=remat, opt_state_dtype=opt_dtype,
        microbatches=microbatches))
    params = init_params(model.specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         cfg.dtype)
    state = (params, opt.init(params))
    del params
    b = make_global_batch(SyntheticLM(cfg, batch=batch, seq=seq).at_step(0),
                          mesh, cfg.dtype)
    for _ in range(2):
        state = step(*state, b)[:2]
    torch.cuda.synchronize(dev)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = step(*state, b)[:2]
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in kernels)
    ops = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    profile = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
               "kernels": len(kernels),
               "top_ops": [(e.key, e.count, e.device_time_total / 1e3)
                           for e in ops[:TOP]]}

    resident = torch.cuda.memory_allocated(dev)
    mark = {}
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        state = step(*state, b, mark=lambda: mark.setdefault(
            "at", len(torch.cuda.memory._snapshot()["device_traces"][0])))
        torch.cuda.synchronize(dev)
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    memory = {"resident_bytes": resident,
              "grads": peak_sites(trace[:mark["at"]]),
              "update": peak_sites(trace[mark["at"]:])}
    return {"arch": arch, "batch": batch, "seq": seq, "remat": remat,
            "opt_dtype": opt_dtype, "microbatches": microbatches,
            "device": torch.cuda.get_device_name(dev), "profile": profile,
            "memory": memory}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    rep = profile_step(args.arch, args.batch, args.seq, args.remat,
                       args.opt_dtype, args.microbatches)
    text = json.dumps(rep, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return rep


if __name__ == "__main__":
    main()
