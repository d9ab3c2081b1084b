"""The dry run of every (arch × shape) cell, on one card or sharded over
the production mesh; the port of ``src/repro/launch/dryrun.py``.

For each cell the step (``make_train_step`` for train shapes, ``forward``
for prefill, ``decode_step`` over ``init_cache(B, S)`` for decode) runs
once on ``meta`` tensors: every operator runs its shape logic and nothing
is allocated, so a cell of any size answers on a laptop whether its step
fits in a card's memory, what it costs, and which roofline term bounds
it. The reference lowers and compiles each cell for a 256- or 512-device
mesh and reads XLA's memory and cost analysis. The port runs a cell on
one of three meshes (``mesh=``):

* ``"1"`` (the default): one card, ``chips = 1``, no collective;
* ``"16x16"`` and ``"2x16x16"`` (``multi_pod=True``): the production
  mesh of 256 or 512 ranks (``launch.mesh.make_production_mesh``) over a
  fake process group (``torch.distributed``'s ``fake`` backend: every
  collective returns at once and moves nothing), as its rank 0. The
  parameters, optimizer moments, cache and inputs are DTensors of
  ``meta`` shards placed as the reference places them
  (``tree_shardings(params=True)``, ``opt_state_shardings``,
  ``input_specs``), and the step runs under ``use_mesh(mesh, rules)``.
  Every count below is then rank 0's: its shards, its local operators,
  its collectives. A process holds one process group: the fake one is
  set up and torn down around each cell, and a cell refuses to run where
  another group is up (run it in a spawned worker).

What a result holds, under the reference's keys where they mean the same:

* ``memory``: ``args_bytes``, the parameters, optimizer state, cache and
  inputs (per device: the shards), counted from their shapes and dtypes;
  ``temp_bytes``, the step's peak of storages it created and still held
  (outputs and all-gathered operands included: the step returns new
  trees while the caller still holds the old ones, as a real step on the
  card does); ``peak_bytes`` = the two summed; ``output_bytes``;
  ``fits``, ``peak_bytes`` against ``capacity_bytes`` (the caller's
  figure, else the card's ``total_memory`` when one is visible, else the
  H100 SXM datasheet's 80 GB).
* ``raw_cost_analysis``: ``flops``, the step's counted products
  (matmuls, convolutions, attention; elementwise work counts nothing;
  ``torch.utils.flop_counter``'s formulas, on rank 0's local operators
  when sharded), the backward and any recomputation included (remat
  "full" recomputes a group's forward only up to its last saved tensor:
  torch's checkpoint stops early, so a group's last product is not
  counted again, where the analytic model adds a whole forward);
  ``bytes``, the input and output bytes of every dispatched operator,
  the closest counterpart of XLA's "bytes accessed" (each operator reads
  its inputs and writes its outputs once; a fused kernel would move
  less).
* ``collective_bytes`` (trip-corrected operand bytes by kind),
  ``collective_bytes_uncorrected``, ``collective_wire_bytes``,
  ``collective_total`` and ``collective_wire_total``: the collectives
  rank 0 issued in the step (``hlo_analysis.CollectiveMeter``), with the
  reference's formulas (``hlo_analysis.collective_bytes``); empty on one
  card.
* ``flops_per_device`` and ``bytes_per_device`` from the analytic model
  (``launch/analytic.py``) over the chips, as the reference's roofline
  uses them, and ``roofline``/``dominant`` from ``launch/hlo_analysis.py``
  at the H100's rates (``collective_s`` and ``collective_wire_s`` at its
  NVLink rate).
* ``model_flops_total``, ``useful_flops_ratio``, ``params_total`` and
  ``params_active``, as in the reference.

Usage:
    python -m repro_torch.launch.dryrun --arch mamba2-370m --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--mesh 16x16] [--multi-pod] \\
        [--cache-shard seq|kv|none] [--out results/]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..configs import SHAPES, TrainConfig, get_config, shapes_for
from ..configs.base import ModelConfig, ShapeConfig
from ..configs.registry import ASSIGNED
from ..distributed.sharding import distribute_tree, use_mesh
from ..models.lm import N_PATCHES, build_model
from ..models.spec import (abstract_params, axes_tree, init_params,
                           is_spec, torch_dtype, tree_leaves)
from ..train.train_step import make_train_step
from . import analytic
from . import hlo_analysis as H

H100_MEMORY_BYTES = 80e9   # NVIDIA H100 SXM datasheet: 80 GB HBM3
MESH = "1"
# mesh name -> (chips, multi_pod) of the production meshes
MESHES = {"16x16": (256, False), "2x16x16": (512, True)}


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, torch.Tensor]:
    """Every model input of this cell: tensors on ``meta`` (allocating
    nothing) unless another device is asked for, then zeros there. Tokens
    are int64, as the port's data pipeline gives them."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    i64 = torch.int64
    make = (torch.empty if torch.device(device).type == "meta"
            else torch.zeros)

    def t(*dims, dtype=i64):
        return make(dims, dtype=dtype, device=device)

    if shape.kind == "decode":
        return {"tokens": t(B, 1), "pos": t(B)}
    specs = {"tokens": t(B, S)}
    if shape.kind == "train":
        specs["targets"] = t(B, S)
    if cfg.family == "encdec":
        specs["frames"] = t(B, cfg.enc_seq, cfg.d_model, dtype=dt)
    if cfg.family == "vlm":
        specs["patch_embeds"] = t(B, N_PATCHES, cfg.d_model, dtype=dt)
    return specs


def n_params(cfg: ModelConfig, active_only=False) -> float:
    """Parameter count from the spec tree (active = top-k experts only)."""
    total = 0.0
    for s in tree_leaves(build_model(cfg).specs(), is_spec):
        n = math.prod(s.shape)
        if active_only and "experts" in (s.axes or ()):
            n = n * max(cfg.experts_per_tok, 1) / max(cfg.n_experts, 1)
        total += n
    return total


def default_train_config() -> TrainConfig:
    """The reference's dry-run setting: full remat, int8 moments and 8
    microbatches, which keep a step's live activations honest."""
    return TrainConfig(remat="full", opt_state_dtype="int8", microbatches=8)


def build_step(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig,
               device="meta", mesh=None) -> Tuple[Callable, tuple]:
    """``(step, args)`` for one cell: ``step(*args)`` runs the cell's
    step once. On ``meta`` every argument is a shape; on a real device the
    parameters are drawn from a generator seeded with 0 and the cache,
    optimizer state and inputs are zeros. On a process-group ``mesh``
    every argument is a DTensor placed by its logical axes (parameters by
    ``PARAM_RULES``, the rest by the active rules, optimizer moments by
    ``optim.optimizer.state_placements``); call it under ``use_mesh``."""
    model = build_model(cfg)
    specs = model.specs()
    meta = torch.device(device).type == "meta"
    if meta:
        params = abstract_params(specs, cfg.dtype)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(specs, gen, cfg.dtype, device)
    batch = input_specs(cfg, shape, device)
    sharded = getattr(mesh, "device_mesh", None) is not None
    if sharded:
        params = distribute_tree(params, axes_tree(specs), mesh,
                                 params=True)
        batch = distribute_tree(batch, {k: ("batch",) + (None,) * (
            v.ndim - 1) for k, v in batch.items()}, mesh)
    if shape.kind == "train":
        step_fn, opt = make_train_step(model, tc)
        state = (opt.abstract_init(params) if meta and not sharded
                 else opt.init(params))
        return step_fn, (params, state, batch)
    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return model.forward(params, batch)[0]
        return prefill, (params, batch)
    cache = model.init_cache(shape.global_batch, shape.seq_len, cfg.dtype,
                             device=device)
    if sharded:
        cache = distribute_tree(cache, model.cache_axes(), mesh)

    def decode(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos)
    return decode, (params, cache, batch["tokens"], batch["pos"])


def _tensors(tree) -> list:
    """Every tensor in a tree of dicts, lists, tuples and named tuples
    (``QTensor`` moments included); a DTensor's local shard stands for
    it."""
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class StepMeter(TorchDispatchMode):
    """Counts, over the operators dispatched inside it, the input and
    output bytes of each (``io_bytes``), and the bytes of the storages
    they create while those live (``live``, its ``peak``). The storages
    of ``held`` (the step's arguments) are not counted. With
    ``count_flops`` it also sums ``torch.utils.flop_counter``'s formula
    for every product it sees (``flops``).

    It sits beneath DTensor: an operator on DTensors is let through
    (``NotImplemented``) and the meter counts the local operators and
    collectives DTensor turns it into, with this rank's shapes."""

    def __init__(self, held=(), count_flops: bool = False):
        super().__init__()
        self.io_bytes = 0
        self.live = 0
        self.peak = 0
        self.flops = 0
        self.count_flops = count_flops
        self._known = {t.untyped_storage()._cdata for t in _tensors(held)}

    def _free(self, key, n):
        self._known.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, FakeTensor) for t in _tensors(out)):
            return out      # DTensor's shape propagation: nothing is made
        if self.count_flops and \
                getattr(func, "_overloadpacket", None) in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **(kwargs or {}), out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.io_bytes += sum(x.numel() * x.element_size()
                             for x in ins + outs)
        for x in outs:
            st = x.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)
        return out


def measure_step(step: Callable, args: tuple,
                 sharded: bool = False) -> Dict[str, Any]:
    """Runs ``step(*args)`` once under a flop counter and a
    :class:`StepMeter`: its counted flops, operator bytes, the peak bytes
    of the storages it created, and its outputs' bytes. ``sharded`` (a
    step on DTensors) counts the flops of rank 0's local operators and
    records its collectives (``collectives``, the
    ``hlo_analysis.CollectiveMeter`` records)."""
    meter = StepMeter(args, count_flops=sharded)
    if sharded:
        coll = H.CollectiveMeter()
        with coll, meter:
            out = step(*args)
        flops, records = meter.flops, coll.records
    else:
        count = FlopCounterMode(display=False)
        with count, meter:
            out = step(*args)
        flops, records = count.get_total_flops(), []
    held = {t.untyped_storage()._cdata for t in _tensors(args)}
    out_bytes = _storage_bytes([t for t in _tensors(out)
                                if t.untyped_storage()._cdata not in held])
    return {"flops": float(flops), "bytes": float(meter.io_bytes),
            "temp_bytes": int(meter.peak), "output_bytes": int(out_bytes),
            "collectives": records}


def _capacity(capacity_bytes: Optional[float]) -> float:
    if capacity_bytes is not None:
        return float(capacity_bytes)
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return H100_MEMORY_BYTES


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the length of the block (``torch.distributed``'s ``fake`` backend:
    collectives return at once and move nothing). Refuses where a process
    group is already up: one process holds one group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process; "
                           "run the sharded dry run in a spawned worker")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             tc: Optional[TrainConfig] = None,
             rules: Optional[dict] = None,
             cfg_overrides: Optional[dict] = None, *,
             capacity_bytes: Optional[float] = None,
             mesh: str = MESH) -> Dict[str, Any]:
    """One cell's dry run on ``meta`` (the module docstring lists what it
    returns): on one card (``mesh="1"``), or as rank 0 of the production
    mesh ``"16x16"`` or ``"2x16x16"`` (``multi_pod=True`` picks the
    latter). ``capacity_bytes`` is the memory ``fits`` compares with."""
    if multi_pod:
        mesh = "2x16x16"
    if mesh != MESH and mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: expected '1' or one of "
                         f"{sorted(MESHES)}")
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    tc = tc or default_train_config()
    capacity = _capacity(capacity_bytes)
    t0 = time.time()
    if mesh == MESH:
        chips = 1
        step, args = build_step(cfg, shape, tc, "meta")
        args_bytes = _storage_bytes(_tensors(args))
        with use_mesh(None, rules):
            counted = measure_step(step, args)
    else:
        from .mesh import make_production_mesh
        chips, pod = MESHES[mesh]
        with fake_group(chips):
            pmesh = make_production_mesh(multi_pod=pod, device_type="cpu")
            with use_mesh(pmesh, rules):
                step, args = build_step(cfg, shape, tc, "meta", pmesh)
                args_bytes = _storage_bytes(_tensors(args))
                counted = measure_step(step, args, sharded=True)
            del step, args

    N_total = n_params(cfg)
    N_active = n_params(cfg, active_only=True)
    a_flops = analytic.cell_flops(cfg, shape, tc) / chips
    a_bytes = analytic.cell_bytes(cfg, shape, tc, N_total) / chips
    coll_raw, coll_corr, coll_wire = H.collective_bytes(
        counted["collectives"])
    coll_total = float(sum(coll_corr.values()))
    wire_total = float(sum(coll_wire.values()))
    terms = H.roofline_terms(a_flops, a_bytes, coll_total, chips)
    terms["collective_wire_s"] = wire_total / H.H100_NVLINK_BW
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mf = H.model_flops(N_active, tokens, shape.kind)
    peak = args_bytes + counted["temp_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh, "chips": chips,
        "kind": shape.kind, "ok": True,
        "wall_s": round(time.time() - t0, 1),
        "memory": {
            "args_bytes": args_bytes,
            "output_bytes": counted["output_bytes"],
            "temp_bytes": counted["temp_bytes"],
            "peak_bytes": peak,
            "capacity_bytes": capacity,
            "fits": peak <= capacity,
        },
        "flops_per_device": a_flops,
        "bytes_per_device": a_bytes,
        "raw_cost_analysis": {"flops": counted["flops"],
                              "bytes": counted["bytes"]},
        "collective_bytes": coll_corr,
        "collective_bytes_uncorrected": coll_raw,
        "collective_wire_bytes": coll_wire,
        "collective_total": coll_total,
        "collective_wire_total": wire_total,
        "roofline": terms,
        "dominant": H.dominant(terms),
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / chips / a_flops) if a_flops else None,
        "params_total": N_total,
        "params_active": N_active,
    }


def all_cells() -> list:
    """Every (arch, shape name) cell of the assigned configs."""
    return [(arch, s.name) for arch in ASSIGNED
            for s in shapes_for(get_config(arch))]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=MESH, choices=[MESH, "16x16"],
                    help="one card, or rank 0 of the 16x16 production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (512 ranks)")
    ap.add_argument("--out", default="results")
    ap.add_argument("--cache-shard", default="seq",
                    choices=["seq", "kv", "none"],
                    help="decode KV-cache sharding strategy")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    mesh = "2x16x16" if args.multi_pod else args.mesh

    rules = None
    if args.cache_shard == "kv":
        rules = {"cache_seq": None, "kv_heads": "model"}
    elif args.cache_shard == "none":
        rules = {"cache_seq": None}

    os.makedirs(args.out, exist_ok=True)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{mesh}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag}")
            continue
        print(f"[cell] {tag} ...", flush=True)
        try:
            res = run_cell(arch, shape, rules=rules, mesh=mesh)
        except Exception as e:  # noqa: BLE001 — record the failure
            res = {"arch": arch, "shape": shape, "ok": False, "mesh": mesh,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = "OK" if res.get("ok") else "FAIL"
        mem = res.get("memory", {})
        print(f"[{status}] {tag} ({res.get('wall_s', '?')}s, "
              f"peak={mem.get('peak_bytes', 0) / 1e9:.2f} GB, "
              f"fits={mem.get('fits')}, "
              f"collective={res.get('collective_total', 0) / 1e9:.3f} GB, "
              f"dom={res.get('dominant')})", flush=True)


if __name__ == "__main__":
    main()
