"""Serving launcher: batched requests through the continuous-batching
engine, the port of ``src/repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        [--smoke] [--device cuda|cpu] [--dtype bfloat16|float32] \\
        [--requests 8] [--max-new 16] [--max-batch 4] [--max-seq 128]

Weights are random, drawn from a ``torch.Generator`` seeded with 0 on the
serving device; prompts are the reference's (``numpy`` seed 0, lengths 8
to 15). Under ``torchrun`` the model is sharded over a mesh of every
rank (``launch.mesh.mesh_from_env``: the production mesh at 256 or 512
ranks, else data parallelism); otherwise it runs on one device
(``make_local_mesh``). ``--smoke`` serves the reduced config; without it,
the config at full width.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..distributed.sharding import distribute_tree, use_mesh
from ..models.lm import build_model
from ..models.spec import axes_tree, init_params, param_bytes, param_count
from ..serve.engine import Engine, Request
from .mesh import mesh_from_env


def serve(arch: str = "olmo-1b", smoke: bool = False, requests: int = 8,
          max_new: int = 16, max_batch: int = 4, max_seq: int = 128,
          device="cuda", dtype: Optional[str] = None, seed: int = 0,
          mesh=None) -> dict:
    """Build the model, serve ``requests`` prompts to completion and
    return what happened: results per uid, the wall, the engine (with its
    device timings), parameter count and bytes. ``mesh`` (default:
    ``mesh_from_env``) places the parameters: on a process-group mesh
    every rank draws the same weights and keeps its shards."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    mesh = mesh if mesh is not None else mesh_from_env(device)
    dev = mesh.local_device
    rng = np.random.default_rng(0)
    with use_mesh(mesh):
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        specs = model.specs()
        params = distribute_tree(init_params(specs, gen, cfg.dtype),
                                 axes_tree(specs), mesh, params=True)
        eng = Engine(model, params, max_batch=max_batch, max_seq=max_seq)
        reqs = [Request(uid=i,
                        prompt=rng.integers(1, cfg.vocab,
                                            (8 + i % 8,)).astype(np.int64),
                        max_new=max_new)
                for i in range(requests)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        results = eng.run(reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return {"cfg": cfg, "results": results, "wall_s": wall, "engine": eng,
            "requests": reqs, "params": param_count(params),
            "param_bytes": param_bytes(params)}


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="parameter and activation dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)

    rep = serve(args.arch, smoke=args.smoke, requests=args.requests,
                max_new=args.max_new, max_batch=args.max_batch,
                max_seq=args.max_seq, device=args.device, dtype=args.dtype)
    results, dt = rep["results"], rep["wall_s"]
    n_tok = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    for uid in sorted(results)[:4]:
        print(f"  req {uid}: {results[uid]}")
    return rep


if __name__ == "__main__":
    main()
