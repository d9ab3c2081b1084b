"""1-bit gradient compression with error feedback (cross-pod all-reduce),
the port of ``src/repro/optim/grad_compress.py``.

MatPIM's binary quantization (majority over ±1 products) applied to
distributed optimization: sign-compress gradients before the slow
cross-pod reduction, keep the quantization residual locally (error
feedback), and rescale by the mean magnitude. Intra-pod reductions stay
full-precision; only the 'pod' axis sees the compressed values.

The reference's ``pmean`` over ``axis_name`` is an all-reduce over that
axis of the active process-group mesh (``use_mesh``), divided by its size.
Without such a mesh, or on one without that axis, it is the identity, as
the reference's ``pmean`` outside ``shard_map`` is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..distributed.sharding import current_mesh
from ..models.spec import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


def init_error(params):
    """Zero error feedback beside every leaf (a DTensor leaf gets a
    DTensor of its placements)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def _axis_group(axis_name: str):
    """The process group of ``axis_name`` on the active mesh, or None."""
    mesh = current_mesh()
    dm = getattr(mesh, "device_mesh", None)
    if dm is None or axis_name not in mesh.axis_names:
        return None
    return dm.get_group(axis_name)


def compress_decompress(grads, error, axis_name: str = "pod"):
    """Sign+scale compress each gradient leaf, average the compressed
    values over ``axis_name`` (majority vote ≈ mean of signs), and update
    the error feedback. Returns ``(new_grads, new_error)``.

    Each leaf is this rank's gradient: a plain tensor, or a DTensor whose
    local shard is compressed as the reference's ``shard_map`` body sees
    its block (the result keeps the leaf's placements). The error
    feedback stays with the rank."""
    group = _axis_group(axis_name)
    n = dist.get_world_size(group) if group is not None else 1

    def one(g, e):
        local = isinstance(g, DTensor)
        gl = g.to_local() if local else g
        gf = gl.to(F32) + (e.to_local() if local else e)
        scale = torch.mean(torch.abs(gf))
        sign = torch.where(gf >= 0, scale, -scale)
        reduced = sign
        if group is not None:
            reduced = sign.clone()
            dist.all_reduce(reduced, group=group)
            reduced = reduced / n
        reduced, new_e = reduced.to(g.dtype), gf - sign
        if local:
            reduced, new_e = (DTensor.from_local(t, g.device_mesh,
                                                 g.placements,
                                                 run_check=False)
                              for t in (reduced, new_e))
        return reduced, new_e

    flat_g = tree_leaves(grads)
    outs = [one(g, e) for g, e in zip(flat_g, tree_leaves(error))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def compression_stats(grads) -> dict:
    """Wire bytes with/without compression."""
    leaves = tree_leaves(grads)
    full = sum(g.numel() * 4 for g in leaves)
    compressed = sum(g.numel() // 8 + 4 for g in leaves)
    return {"full_bytes": full, "onebit_bytes": compressed,
            "ratio": full / max(compressed, 1)}


__all__ = ["compress_decompress", "compression_stats", "init_error"]
