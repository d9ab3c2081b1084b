"""Training launcher, the port of ``src/repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        [--smoke] [--device cuda|cpu] [--steps 20] [--batch 8] [--seq 64] \\
        [--lr 1e-3] [--microbatches 1] [--remat none] \\
        [--opt-dtype float32] [--ckpt-dir DIR] [--ckpt-every 25]

``--smoke`` trains the reduced config; without it, the config at full
width. Under ``torchrun`` the parameters, moments and batches are
sharded over a mesh of every rank (``launch.mesh.mesh_from_env``);
otherwise the run takes one device, where the reference takes its
production mesh. The weights are random, drawn from a ``torch.Generator`` seeded with 0 on the
training device; the batches are ``SyntheticLM``'s. The loop runs under
the fault-tolerance supervisor: checkpoint cadence (on a sharded run
rank 0 writes every leaf whole, in the one-device layout), crash recovery,
straggler flagging. It prints the reference's lines: ``step … loss …
gnorm … s/step`` every 5 steps and at the last, then ``done.``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs import TrainConfig, get_config
from ..data.pipeline import SyntheticLM, make_global_batch
from ..distributed.fault_tolerance import run_resilient_loop
from ..distributed.sharding import distribute_tree, use_mesh
from ..models.lm import build_model
from ..models.spec import axes_tree, init_params, param_count, tree_leaves
from ..train.train_step import make_train_step
from .mesh import mesh_from_env


class _StepMeter:
    """On the card, for every step: CUDA events at its start, between its
    gradients and its optimizer update, and at its end; and the peak of
    allocated memory in each of the two parts (the allocator's statistics,
    reset at the step's start and at the mark)."""

    def __init__(self, device):
        self.device = device
        self.events: List[list] = []
        self.peaks: List[tuple] = []
        self.setup_peak = 0
        self._grads_peak = 0

    def wrap(self, train_step: Callable) -> Callable:
        cuda = torch.cuda

        def mark(ev):
            ev.record()
            self._grads_peak = cuda.max_memory_allocated(self.device)
            cuda.reset_peak_memory_stats(self.device)

        def step(params, opt_state, batch):
            ev = [cuda.Event(enable_timing=True) for _ in range(3)]
            if not self.events:     # the peak of the set-up, before step 0
                self.setup_peak = cuda.max_memory_allocated(self.device)
            cuda.reset_peak_memory_stats(self.device)
            ev[0].record()
            out = train_step(params, opt_state, batch,
                             mark=lambda: mark(ev[1]))
            ev[2].record()
            self.events.append(ev)
            self.peaks.append((self._grads_peak,
                               cuda.max_memory_allocated(self.device)))
            return out
        return step

    def read(self) -> Dict[str, list]:
        torch.cuda.synchronize(self.device)
        return {"step_ms": [a.elapsed_time(c) for a, _, c in self.events],
                "grads_ms": [a.elapsed_time(b) for a, b, _ in self.events],
                "update_ms": [b.elapsed_time(c) for _, b, c in self.events],
                "grads_peak_bytes": [g for g, _ in self.peaks],
                "update_peak_bytes": [u for _, u in self.peaks]}


def train(arch: str = "olmo-1b", smoke: bool = False, steps: int = 20,
          batch: int = 8, seq: int = 64, lr: float = 1e-3,
          microbatches: int = 1, remat: str = "none",
          opt_dtype: str = "float32", ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, device="cuda",
          log: Optional[Callable[[str], None]] = None, mesh=None) -> dict:
    """Build the model, train ``steps`` steps and return what happened:
    the config, the final parameters and optimizer state, every step's
    loss and gradient norm, and on the card each step's ms (whole, its
    gradients with their norm, its update; CUDA events), each part's peak
    of allocated memory, and the peak over the whole run (set-up
    included). ``ckpt_dir=None`` takes no checkpoints; ``log`` gets the
    printed lines. ``mesh`` (default: ``mesh_from_env``) places the
    parameters, moments and batches; a run sharded over a process group
    writes its checkpoints from rank 0, in the one-device layout."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    mesh = mesh if mesh is not None else mesh_from_env(device)
    dev = mesh.local_device
    on_card = dev.type == "cuda"
    tc = TrainConfig(lr=lr, microbatches=microbatches, remat=remat,
                     opt_state_dtype=opt_dtype)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    with use_mesh(mesh):
        model = build_model(cfg)
        step_fn, opt = make_train_step(model, tc)

        def first_state():
            gen = torch.Generator(device=dev).manual_seed(0)
            specs = model.specs()
            params = distribute_tree(init_params(specs, gen, cfg.dtype),
                                     axes_tree(specs), mesh, params=True)
            return params, opt.init(params)

        # the loop gets the only reference to the first state (a name here
        # would keep its parameters and moments alive for the whole run)
        first = [first_state()]
        meter = _StepMeter(dev) if on_card else None
        jstep = meter.wrap(step_fn) if on_card else step_fn
        src = SyntheticLM(cfg, batch=batch, seq=seq)
        ck = Checkpointer(ckpt_dir) if ckpt_dir is not None else None
        metrics: Dict[int, dict] = {}

        def batch_at(i):
            return make_global_batch(src.at_step(i), mesh, cfg.dtype)

        t_start = time.time()

        def on_metrics(step, m):
            metrics[step] = m
            if log and (step % 5 == 0 or step == steps - 1):
                log(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                    f"gnorm {float(m['grad_norm']):.3f}  "
                    f"{(time.time()-t_start)/(step+1):.2f}s/step")

        params, opt_state = run_resilient_loop(
            jstep, first.pop(), batch_at, ck, n_steps=steps,
            ckpt_every=ckpt_every, on_metrics=on_metrics)
    out = {"cfg": cfg, "tc": tc, "params": params, "opt_state": opt_state,
           "n_params": param_count(params),
           "opt_state_bytes": sum(t.numel() * t.element_size()
                                  for t in tree_leaves(opt_state)),
           "losses": [float(metrics[s]["loss"]) for s in sorted(metrics)],
           "grad_norms": [float(metrics[s]["grad_norm"])
                          for s in sorted(metrics)],
           "wall_s": time.time() - t_start}
    if on_card:
        out.update(meter.read())
        out["peak_memory_bytes"] = max(
            [meter.setup_peak] + out["grads_peak_bytes"]
            + out["update_peak_bytes"])
    return out


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rep = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                microbatches=args.microbatches, remat=args.remat,
                opt_dtype=args.opt_dtype, ckpt_dir=args.ckpt_dir or None,
                ckpt_every=args.ckpt_every, device=args.device,
                log=lambda line: print(line, flush=True))
    print("done.")
    return rep


if __name__ == "__main__":
    main()
