"""Roofline terms and the collective schedule of one step, the port of
``src/repro/launch/hlo_analysis.py``.

compute    = FLOPs / peak FLOP/s
memory     = bytes / HBM bandwidth
collective = collective bytes / link bandwidth

Each term is in seconds for the per-device counts a caller passes. The
rates are keyword parameters; their defaults are the datasheet rates of
one NVIDIA H100 SXM (989 TFLOP/s dense bfloat16, 3.35 TB/s HBM3, 450 GB/s
NVLink each way), the card the port runs on.

The collective schedule: the reference reads the collectives of the
optimized XLA HLO of a program compiled for a device mesh
(``collective_bytes(hlo)``) and multiplies those inside while-loop bodies
by the loops' trip counts (``parse_computations``, ``while_multipliers``,
``_shape_bytes``). A torch step compiles no HLO: it runs eagerly and
issues its collectives one by one. :class:`CollectiveMeter` records each
one a step issues on this rank (its kind, result bytes and group size),
and :func:`collective_bytes` sums the records with the reference's
operand and wire formulas. An eager step runs every loop iteration, so
each trip is a record of its own: the trip correction is 1 by
construction and the corrected bytes equal the operand bytes. The three
HLO-text readers have nothing to read and are not ported.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM datasheet rates (per card)
H100_PEAK_FLOPS = 989e12     # dense bfloat16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12        # HBM3 bytes/s
H100_NVLINK_BW = 450e9       # NVLink bytes/s, each direction


# dispatched collective op -> the reference's kind (XLA's HLO op names).
# Functional collectives (``_c10d_functional``) are what DTensor issues;
# the ``c10d`` ops are those of ``torch.distributed.all_reduce`` and its
# kin; ``_dtensor.shard_dim_alltoall`` is DTensor's all-to-all on a card.
_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}


def _op_name(func) -> str:
    return f"{func.namespace}.{func._opname}"


def _group_size(func, args) -> int:
    """The group size a collective's arguments name: a ``c10d`` op's
    process group object; a functional collective's integer
    ``group_size``, else its group name (its last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    rest = args[1:]
    if func.namespace == "c10d":
        for a in rest:
            if isinstance(a, torch.ScriptObject):
                return torch.distributed.ProcessGroup.unbox(a).size()
        return 1
    for a in rest:
        if isinstance(a, int) and not isinstance(a, bool):
            return a
    names = [a for a in rest if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size() if names else 1


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


class CollectiveMeter(TorchDispatchMode):
    """Records every collective this rank issues inside it:
    ``records`` holds ``(kind, result_bytes, group_size)`` in issue order,
    with the reference's kinds (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``).

    It sits beneath DTensor: an operator on DTensors is let through
    (``NotImplemented``) so that DTensor turns it into the local
    operators and collectives the meter then sees. On a CPU mesh DTensor
    replaces an all-to-all (a ``Shard(i)`` -> ``Shard(j)``
    redistribution) by an all-gather and a local chunk, since gloo has no
    all-to-all; the meter records that exchange as the all-to-all NCCL
    issues on a card, with the all-to-all's result bytes, and not the
    all-gather that stands in for it."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, int, int]] = []
        self._stand_in = 0
        self._patch = contextlib.ExitStack()

    def __enter__(self):
        from torch.distributed.tensor import placement_types as pt
        real = pt.shard_dim_alltoall

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu":
                return real(input, gather_dim, shard_dim, mesh, mesh_dim)
            self._stand_in += 1
            try:
                out = real(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._stand_in -= 1
            self.records.append(("all-to-all", _nbytes(out),
                                 mesh.size(mesh_dim)))
            return out

        self._patch.enter_context(_patched(pt, "shard_dim_alltoall",
                                           alltoall))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patch.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(_op_name(func)) if hasattr(func, "_opname") \
            else None
        if kind is not None and not self._stand_in:
            res = out
            if func._opname in ("allgather_", "reduce_scatter_",
                                "alltoall_"):
                res = args[0]                 # the output list argument
            elif func.namespace == "c10d" and isinstance(out, tuple):
                res = out[0]
            self.records.append((kind, _nbytes(res), _group_size(func, args)))
        return out


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def collective_bytes(records) -> Tuple[Dict[str, int], Dict[str, int],
                                       Dict[str, int]]:
    """(operand bytes, trip-corrected operand bytes, wire bytes) by
    collective kind, over :class:`CollectiveMeter` records, with the
    reference's formulas.

    Operand bytes: all-reduce / all-to-all / collective-permute operand ==
    result; all-gather operand = result / group_size; reduce-scatter
    operand = result × group_size. Wire bytes, what crosses a device's
    links under ring algorithms: AG ≈ result·(g−1)/g, RS ≈
    result·g·(g−1)/g, AR ≈ 2·result·(g−1)/g, A2A ≈ result·(g−1)/g,
    permute = result. Every loop trip of an eager step is a record, so
    the corrected bytes equal the operand bytes.

    >>> raw, corr, wire = collective_bytes([("all-gather", 512, 16)])
    >>> raw["all-gather"], wire["all-gather"]
    (32, 480)
    """
    raw: Dict[str, int] = {}
    wire: Dict[str, int] = {}
    for kind, result_bytes, gsize in records:
        gsize = max(int(gsize), 1)
        frac = (gsize - 1) / gsize
        if kind == "all-gather":
            operand = result_bytes // gsize
            w = int(result_bytes * frac)
        elif kind == "reduce-scatter":
            operand = result_bytes * gsize
            w = int(result_bytes * gsize * frac)
        elif kind == "all-reduce":
            operand = result_bytes
            w = int(2 * result_bytes * frac)
        elif kind == "all-to-all":
            operand = result_bytes
            w = int(result_bytes * frac)
        else:  # collective-permute
            operand = result_bytes
            w = result_bytes
        raw[kind] = raw.get(kind, 0) + operand
        wire[kind] = wire.get(kind, 0) + w
    return raw, dict(raw), wire


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, *, peak_flops: float = H100_PEAK_FLOPS,
                   hbm_bw: float = H100_HBM_BW,
                   link_bw: float = H100_NVLINK_BW) -> Dict[str, float]:
    """Terms in seconds. ``flops``/``bytes_accessed``/``coll_bytes`` are
    per device; ``chips`` is kept for the reference's signature (the
    counts are already per device)."""
    return {
        "compute_s": flops / peak_flops,
        "memory_s": bytes_accessed / hbm_bw,
        "collective_s": coll_bytes / link_bw,
    }


def dominant(terms: Dict[str, float]) -> str:
    """The largest of the three terms (the first on a tie)."""
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def model_flops(n_params_active: float, tokens: float, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


__all__ = ["CollectiveMeter", "H100_HBM_BW", "H100_NVLINK_BW",
           "H100_PEAK_FLOPS", "collective_bytes", "dominant", "model_flops",
           "roofline_terms"]
