"""1-bit gradient compression with error feedback, the port of
``src/repro/optim/grad_compress.py``.

MatPIM's binary quantization (majority over ±1 products) applied to
distributed optimization: sign-compress gradients before the slow
cross-pod reduction, keep the quantization residual locally (error
feedback), and rescale by the mean magnitude.

The cross-process reduction is not ported: outside a process group the
reference's ``pmean`` is the identity, and so is this module's.
``compress_decompress`` raises inside an initialized
``torch.distributed`` process group rather than skip the all-reduce.
"""
from __future__ import annotations

import torch

from ..models.spec import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def compress_decompress(grads, error):
    """Sign+scale compress each gradient leaf and update the error
    feedback. Returns ``(new_grads, new_error)``."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        raise NotImplementedError(
            "the cross-process all-reduce of compressed gradients is not "
            "ported; compress_decompress runs outside a process group only")

    def one(g, e):
        gf = g.to(F32) + e
        scale = torch.mean(torch.abs(gf))
        sign = torch.where(gf >= 0, scale, -scale)
        return sign.to(g.dtype), gf - sign

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
