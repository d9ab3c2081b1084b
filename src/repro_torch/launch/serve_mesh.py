"""Serving on an explicit ``(data, model)`` mesh of every rank, beside one
device's plain run: the port's own measurement tool (no reference
module), for the meshes ``launch.mesh.mesh_from_env`` does not build.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.serve_mesh --mesh 1x4 \\
        [--dtype float32] [--device cpu --smoke] [--out serve_mesh.json]

At ``(data=1, model=4)`` the decode cache's sequence ('cache_seq') is
split four ways, so every decode step reduces its softmax's maximum and
sum and its attention output across the ranks (the split-K of the
reference's rules). Each rank serves the requests of ``launch.serve``
three times: on its own device with plain tensors, on the mesh, and on
the mesh under ``hlo_analysis.CollectiveMeter`` (its dispatch mode slows
every operator, so the second run is the one timed). Rank 0 prints one
JSON object: whether every rank's sharded tokens equal the plain run's,
the decode-step ms of both (CUDA events on the card, median over the
warm steps), the first token where each request's sharded tokens
differ from the plain run's, and the collectives of the metered run by
kind.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .hlo_analysis import CollectiveMeter, collective_bytes
from .mesh import make_local_mesh, make_mesh
from .serve import serve


def _warm_median(ms: list) -> float:
    return float(np.median(ms[1:] if len(ms) > 1 else ms))


def _first_divergence(got: dict, want: dict) -> dict:
    """Per uid, the index of the first token ``got`` and ``want`` differ
    at (``None`` where they agree)."""
    out = {}
    for uid, w in want.items():
        g = got.get(uid, [])
        out[uid] = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                        None if len(g) == len(w) else min(len(g), len(w)))
    return out


def compare(mesh, arch: str = "olmo-1b", device="cuda", **serve_kw) -> dict:
    """``launch.serve.serve`` on this rank's device with plain tensors and
    on ``mesh`` (a process-group mesh), then on ``mesh`` under a
    ``CollectiveMeter``: the tokens, decode-step ms and collectives."""
    plain = serve(arch, mesh=make_local_mesh(device), device=device,
                  **serve_kw)
    sharded = serve(arch, mesh=mesh, device=device, **serve_kw)
    meter = CollectiveMeter()
    with meter:
        metered = serve(arch, mesh=mesh, device=device, **serve_kw)
    raw, _, wire = collective_bytes(meter.records)
    decode = {name: rep["engine"].timings()["decode_ms"]
              for name, rep in (("plain", plain), ("sharded", sharded),
                                ("metered", metered))}
    return {
        "mesh": dict(mesh.shape), "arch": arch,
        "dtype": str(plain["cfg"].dtype),
        "tokens_equal": sharded["results"] == plain["results"]
        and metered["results"] == plain["results"],
        "first_divergence": _first_divergence(sharded["results"],
                                              plain["results"]),
        "results": sharded["results"],
        "decode_steps": len(decode["sharded"]),
        "decode_ms_median_warm": {k: _warm_median(v)
                                  for k, v in decode.items()},
        "decode_ms": decode,
        "wall_s": {"plain": plain["wall_s"], "sharded": sharded["wall_s"]},
        "collectives": {"count": len(meter.records),
                        "operand_bytes": raw, "wire_bytes": wire},
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1x4",
                    help="data x model, their product the world size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    shape = tuple(int(n) for n in args.mesh.split("x"))
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        mesh = make_mesh(shape, ("data", "model"), args.device)
        rep = compare(mesh, device=args.device, dtype=args.dtype,
                      smoke=args.smoke)
        equal = [None] * dist.get_world_size()
        dist.all_gather_object(equal, rep["tokens_equal"])
    finally:
        dist.destroy_process_group()
    rep["tokens_equal_every_rank"] = all(equal)
    if int(os.environ.get("RANK", 0)) == 0:
        text = json.dumps({k: v for k, v in rep.items() if k != "results"})
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(text)
    if not rep["tokens_equal_every_rank"]:
        raise SystemExit("sharded tokens differ from the plain run's")
    return rep


if __name__ == "__main__":
    main()
