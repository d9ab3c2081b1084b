"""Sharded tile execution: the engine's batch axis over device slots.

The port of ``src/repro/distributed/mesh_exec.py``. MatPIM's tile grids
are embarrassingly parallel — every crossbar of a block-matvec or conv
batch replays the *identical* compiled program — so the multi-device
mapping is one-dimensional: the batch packs into word chunks, the chunks
split over a ``("tiles",)`` mesh, and every slot replays its chunks on its
own device. No collective is needed: the host tree reduction consumes
per-tile partials, so the sharded path only changes *where* chunks run,
never what they compute — results are bit-identical to the single-device
executors (integer/bitwise ops have no reassociation freedom).

Chunking equals the reference's: a batch of B crossbars becomes S
word-packed chunks, S a multiple of the device count, widths balanced to
``ceil(B/S)`` (20 tiles on 8 devices: ``[3,3,3,3,2,2,2,2]``), every width
at most one canonical word (``MAX_CHUNK`` = ``engine.WORD_BITS``). Slot
``d`` takes chunks ``[d·S/D, (d+1)·S/D)``, as ``shard_map`` splits the
reference's stacked buffer, and replays them as one ``(S/D, C+1, R+1)``
word buffer through the device's replay plan.

Placement is the reference's: the chunk buffer's leading axis is the
logical ``"tiles"`` axis, resolved against the mesh by
:func:`~repro_torch.distributed.sharding.resolve_spec`; when it resolves
to replication, or the mesh has one slot, or the batch is smaller than the
slot count, :func:`try_run_sharded` returns ``None`` and the engine runs
its single-device path.

A slot's device is the mesh's entry for it. On CUDA each slot issues its
work on a stream of its own (:func:`slot_stream`, shared with
``PlanService``'s device slots), so one slot's replay can overlap
another's; slots that name one card share its SMs.
``tile_mesh(devices=["cpu"] * 8)`` stands in for the reference's virtual XLA devices in the CPU tests.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .sharding import Mesh

# logical axis name for the packed chunk (tile batch) dimension; also the
# mesh axis name tile_mesh() creates
TILE_AXIS = "tiles"

# widest packed chunk the sharded path emits (one canonical word,
# == engine.WORD_BITS)
MAX_CHUNK = 32


def tile_mesh(n: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D ``("tiles",)`` mesh over the first ``n`` of ``devices``
    (default: every visible CUDA device; raises without one). Activate it
    with ``distributed.sharding.use_mesh`` or pass it as ``mesh=``.

    >>> tile_mesh(devices=["cpu"] * 8).shape
    {'tiles': 8}
    >>> tile_mesh(3, devices=["cpu"] * 8).size
    3
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("tile_mesh: CUDA is not available; pass "
                               "devices=['cpu', ...] for CPU slots")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if not devs:
        raise ValueError("tile_mesh needs at least one device")
    n = len(devs) if n is None else max(1, min(int(n), len(devs)))
    return Mesh(tuple(devs[:n]), (TILE_AXIS,), {TILE_AXIS: n})


def mesh_devices(mesh) -> int:
    """Size of the mesh's ``tiles`` axis (1 when the axis is absent)."""
    try:
        return int(mesh.shape.get(TILE_AXIS, 1))
    except AttributeError:
        return 1


def chunk_widths(B: int, D: int, cap: int = MAX_CHUNK) -> List[int]:
    """Balanced per-chunk batch widths: S chunks, S a multiple of ``D``,
    every width in ``[floor(B/S), ceil(B/S)]`` and at most ``cap``.

    >>> chunk_widths(20, 8)
    [3, 3, 3, 3, 2, 2, 2, 2]
    >>> chunk_widths(8, 8), sum(chunk_widths(300, 4))
    ([1, 1, 1, 1, 1, 1, 1, 1], 300)
    """
    if B < D:
        raise ValueError(f"batch {B} smaller than device count {D}")
    S = D * max(1, math.ceil(B / (cap * D)))
    base, rem = divmod(B, S)
    return [base + 1 if i < rem else base for i in range(S)]


_streams: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def slot_stream(device, slot: int):
    """``(stream, context)`` of device slot ``slot`` on ``device``: on a
    CUDA device one stream per (card, slot), made on first use and kept,
    so everything placed on a slot (the engine's sharded chunks, a
    ``PlanService`` bucket) queues on the slot's one stream, and distinct
    slots on distinct streams; elsewhere no stream and a null context."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, contextlib.nullcontext()
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    with _streams_lock:
        stream = _streams.get((idx, slot))
        if stream is None:
            stream = _streams[(idx, slot)] = torch.cuda.Stream(device=idx)
    return stream, torch.cuda.stream(stream)


def _slot_devices(mesh, D: int) -> List[torch.device]:
    """The device of each ``tiles`` slot: the mesh's devices along the
    tiles axis, at index 0 of every other axis."""
    axes = list(mesh.axis_names)
    k = axes.index(TILE_AXIS)
    stride = math.prod(mesh.shape[a] for a in axes[k + 1:])
    return [mesh.devices[d * stride] for d in range(D)]


def _replay_plan(cp, variant: str, device):
    if variant == "fused":
        from ..core.fused import _fused_plan
        return _fused_plan(cp, device)
    from ..core.engine import _cycle_plan
    return _cycle_plan(cp, device)


def try_run_sharded(cp, mem: np.ndarray, variant: str, mesh
                    ) -> Optional[Tuple[np.ndarray, int, int]]:
    """Execute batch ``mem`` (B, R, C) uint8 sharded over ``mesh``.

    Returns ``(out_mem, devices, n_chunks)``, or ``None`` when the mesh
    placement does not apply (no ``tiles`` axis, one slot, B < slots, or
    ``resolve_spec`` replicates the chunk axis) — the engine then runs its
    single-device path, bit-identically. ``variant`` is ``"fused"`` or
    ``"unfused"``.
    """
    from ..core.engine import _pack, _replay, _unpack
    from .sharding import resolve_spec

    D = mesh_devices(mesh)
    B = mem.shape[0]
    if D <= 1 or B < D:
        return None
    widths = chunk_widths(B, D)
    C1, R1 = cp.cols + 1, cp.rows + 1
    spec = resolve_spec((TILE_AXIS, None, None), (len(widths), C1, R1),
                        mesh, rules={TILE_AXIS: TILE_AXIS})
    if not spec or spec[0] != TILE_AXIS:    # replicated -> nothing to gain
        return None
    per = len(widths) // D
    offs = np.concatenate([[0], np.cumsum(widths)])
    with _span("engine.sharded", devices=D, chunks=len(widths),
               batch=B, variant=variant):
        outs = []
        for d, dev in enumerate(_slot_devices(mesh, D)):
            stream, ctx = slot_stream(dev, d)
            ws = widths[d * per:(d + 1) * per]
            lo, hi = int(offs[d * per]), int(offs[(d + 1) * per])
            with ctx:
                sub = torch.from_numpy(np.ascontiguousarray(
                    mem[lo:hi], dtype=np.uint8)).to(dev)
                cuts = np.concatenate([[0], np.cumsum(ws)])
                buf = torch.cat([_pack(sub[a:b]) for a, b in
                                 zip(cuts[:-1], cuts[1:])])
                _replay(cp, buf, _replay_plan(cp, variant, dev), None)
                out = torch.cat([_unpack(buf[i:i + 1], wd, cp.rows, cp.cols)
                                 for i, wd in enumerate(ws)])
            outs.append((stream, out))
        host = []
        for stream, out in outs:
            if stream is not None:
                stream.synchronize()
            host.append(out.cpu().numpy())
        res = np.concatenate(host)
    _metrics.counter("engine.sharded.calls").inc()
    _metrics.gauge("engine.sharded.devices").set(D)
    _metrics.histogram("engine.sharded.chunks").observe(len(widths))
    return res, D, len(widths)


__all__ = ["MAX_CHUNK", "TILE_AXIS", "chunk_widths", "mesh_devices",
           "slot_stream", "tile_mesh", "try_run_sharded"]
