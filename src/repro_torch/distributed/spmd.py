"""Products and reshapes of DTensors with the ownership written out.

DTensor picks a sharding for every operator from its own cost model, and
two of its choices break the model stack on the production mesh, where
a logical axis often does not divide the 16-way 'model' axis (whisper's 6
heads, 8 KV heads, a reduced config's 4):

* a product whose weight is replicated over a mesh axis gets its output
  split there anyway (a local chunk of the weight counts as a saving),
  and ``torch.einsum``'s own reshape of that output then splits a head
  axis unevenly, which DTensor refuses;
* a reshape that splits a sharded axis into factors the mesh axis does
  not divide is refused too.

:func:`einsum` decides the sharding itself, mesh axis by mesh axis: of
the index letters the operands are split on there, it keeps the one that
moves the fewest bytes, since every operand split on another letter must
be gathered or exchanged (a tie keeps the first operand's). So an FSDP
weight's 'embed' split is gathered where the activation is split on its
batch and is the larger, and a decode step's query is gathered where the
KV cache is split on its sequence (the split-K of the reference's
'cache_seq' rule), never the cache. Every operand is brought to the
letter (a local chunk where it is replicated), the product runs on the
local shards, and the output is split on the letter, ``Partial`` where
the letter is contracted. :func:`reshape` replicates, over the mesh axes
concerned, a split that would not survive the reshape whole. On plain
tensors both are ``torch.einsum`` and ``Tensor.reshape``.

:func:`softmax` and :func:`logsumexp` reduce over a split axis as XLA's
SPMD partitioner lowers ``jax.nn.softmax`` and ``jax.nn.logsumexp``: each
rank takes its block's maximum, an all-reduce (MAX) makes it global, each
rank sums the exponentials of its shifted block, and an all-reduce (SUM)
adds the sums; the axis is never gathered. So a split-K decode step
reduces the (B, KV, rep, 1, 1) maximum and sum of its logits, then the
``Partial`` output of its second product (the paper's α-block split with
a logarithmic reduction, at mesh level), and the loss's ``logz`` over a
split vocab is vocab-parallel.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .sharding import as_dtensor, contiguous_strides, redistribute


def _parse(eq: str, n: int):
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if len(ins) != n:
        raise ValueError(f"{eq!r} names {len(ins)} operands, got {n}")
    return ins, out


def _letter(p, subs: str) -> Optional[str]:
    return subs[p.dim] if isinstance(p, Shard) else None


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``; on DTensors, sharded as the module
    docstring says. Plain operands join as replicated values."""
    if not any(isinstance(t, DTensor) for t in ops):
        return torch.einsum(eq, *ops)
    ins, out = _parse(eq, len(ops))
    mesh = next(t for t in ops if isinstance(t, DTensor)).device_mesh
    ndim = mesh.ndim
    ops = [as_dtensor(t, mesh) for t in ops]
    # a pending sum is reduced first
    ops = [redistribute(t, tuple(Replicate() if isinstance(p, Partial)
                                 else p for p in t.placements))
           for t in ops]
    letters: List[Optional[str]] = []
    local_bytes = [t.to_local().numel() * t.element_size() for t in ops]
    for m in range(ndim):
        cand = [_letter(t.placements[m], s) for t, s in zip(ops, ins)]
        # the letter that moves the fewest bytes: every operand split on
        # another letter over this mesh axis must be gathered or
        # exchanged; a tie keeps the first operand's letter
        options = list(dict.fromkeys(c for c in cand if c))
        pick = min(options, key=lambda c: sum(
            n for n, o in zip(local_bytes, cand) if o and o != c),
            default=None)
        letters.append(pick)
    want = []
    for t, subs in zip(ops, ins):
        pl = []
        for m, pick in enumerate(letters):
            pl.append(Shard(subs.index(pick)) if pick and pick in subs
                      else Replicate())
        want.append(tuple(pl))
    placed = [redistribute(t, w) for t, w in zip(ops, want)]
    # an operand replicated over a mesh axis that splits the product gets
    # only this rank's part of its gradient there: a pending sum
    grads = [tuple(Partial() if isinstance(w[m], Replicate) and pick
                   else w[m] for m, pick in enumerate(letters))
             for w in want]
    # contiguous: the DTensor below states a contiguous layout, which its
    # later views of the local shard rely on (einsum may return a
    # permuted view)
    local = torch.einsum(eq, *[t.to_local(grad_placements=g)
                               for t, g in zip(placed, grads)]).contiguous()
    out_pl = []
    for pick in letters:
        if pick is None:
            out_pl.append(Replicate())
        elif pick in out:
            out_pl.append(Shard(out.index(pick)))
        else:
            out_pl.append(Partial())
    sizes = {}
    for t, subs in zip(ops, ins):
        sizes.update(zip(subs, t.shape))
    shape = tuple(sizes[c] for c in out)
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``. A DTensor split on dim ``d`` keeps the split
    when ``d`` starts an output dim that its mesh axes divide (a split or
    a merge led by ``d``); any other split is first replicated over its
    mesh axes (an all-gather), so DTensor never meets an uneven view."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    shape = list(shape)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    starts = {}     # prefix product -> the first output dim past it
    acc = 1
    for k, n in enumerate(shape):
        if n != 1:
            starts.setdefault(acc, k)
        acc *= n
    mesh = x.device_mesh
    split = {}
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            split[p.dim] = split.get(p.dim, 1) * mesh.size(m)
    keep = {}
    for d, n_split in split.items():
        k = starts.get(math.prod(x.shape[:d]))
        keep[d] = (k is not None and shape[k] % n_split == 0
                   and (shape[k] <= x.shape[d] and x.shape[d] % shape[k] == 0
                        or shape[k] % x.shape[d] == 0))
    want = tuple(p if not isinstance(p, Shard) or keep.get(p.dim)
                 else Replicate() for p in x.placements)
    return redistribute(x, want).reshape(*shape)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``. A DTensor runs it on each rank's shard (a
    ``local_map``), its ``dim`` gathered first where it is split: a
    running sum needs its whole axis and nothing else. (torch 2.11's
    DTensor has no sharding rule for the ``flip`` of cumsum's backward.)"""
    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim)
    from torch.distributed.tensor.experimental import local_map
    dim = dim % x.ndim
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    return local_map(lambda t: torch.cumsum(t, dim), out_placements=list(pl),
                     in_placements=(pl,),
                     device_mesh=x.device_mesh)(redistribute(x, pl))


def _stats(x: torch.Tensor, dim: int, reduce: Callable):
    """(max, exp(x - max), sum) of ``x`` over ``dim``, where ``x`` is one
    block of the axis and ``reduce(t, op)`` combines a block's statistic
    (``op`` "max" or "sum", ``t`` keeping ``dim`` at size 1) with every
    other block's. The max carries no gradient, and an infinite one
    shifts by 0, as in torch's ``logsumexp``."""
    m = reduce(x.detach().amax(dim, keepdim=True), "max")
    m = torch.where(torch.isinf(m), torch.zeros((), dtype=m.dtype,
                                                device=m.device), m)
    e = torch.exp(x - m)
    return m, e, reduce(e.sum(dim, keepdim=True), "sum")


class _BlockSoftmax(torch.autograd.Function):
    """Softmax of one block with torch's gradient, ``w·(g - Σ g·w)``: the
    sum over the whole axis is one more ``reduce(·, "sum")``."""

    @staticmethod
    def forward(ctx, x, dim, reduce):
        _, e, s = _stats(x, dim, reduce)
        w = e / s
        ctx.save_for_backward(w)
        ctx.dim, ctx.reduce = dim, reduce
        return w

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        gw = ctx.reduce((g * w).sum(ctx.dim, keepdim=True), "sum")
        return w * (g - gw), None, None


class _BlockLogsumexp(torch.autograd.Function):
    """Logsumexp of one block with torch's gradient, ``g·exp(x - lse)``:
    local to each block."""

    @staticmethod
    def forward(ctx, x, dim, reduce):
        m, _, s = _stats(x, dim, reduce)
        lse = (torch.log(s) + m).squeeze(dim)
        ctx.save_for_backward(x, lse)
        ctx.dim = dim
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return (g.unsqueeze(ctx.dim)
                * torch.exp(x - lse.unsqueeze(ctx.dim))), None, None


def block_softmax(x: torch.Tensor, dim: int, reduce: Callable):
    """``torch.softmax`` over the whole axis ``dim``, of which ``x`` is one
    block, and its gradient; ``reduce`` as in :func:`_stats`. A block
    wholly at ``-1e30`` beside a larger one gives exact zeros."""
    return _BlockSoftmax.apply(x, dim, reduce)


def block_logsumexp(x: torch.Tensor, dim: int, reduce: Callable):
    """``torch.logsumexp`` over the whole axis ``dim``, of which ``x`` is
    one block (``dim`` dropped), and its gradient; ``reduce`` as in
    :func:`_stats`."""
    return _BlockLogsumexp.apply(x, dim, reduce)


def _all_reduce(device_mesh, axes: List[int]) -> Callable:
    """``reduce(t, op)``: one functional all-reduce of ``t`` with ``op``
    over each mesh axis in ``axes``."""
    import torch.distributed._functional_collectives as funcol

    def reduce(t, op):
        for m in axes:
            t = funcol.all_reduce(t, op, (device_mesh, m))
            if isinstance(t, funcol.AsyncCollectiveTensor):
                t = t.wait()
        return t
    return reduce


def _over_axis(x: DTensor, dim: int, split_fn, plain_fn, keep: bool):
    """``x`` reduced over ``dim`` on each rank's shard (a ``local_map``):
    through ``split_fn`` and :func:`_all_reduce` over the mesh axes of
    size > 1 that split ``dim``, else ``plain_fn`` on the shard. Every
    other placement of ``x`` is kept; ``dim`` too where ``keep``."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    # a pending sum is reduced first
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    x = redistribute(x, pl)
    axes = [m for m, p in enumerate(pl) if isinstance(p, Shard)
            and p.dim == dim and mesh.size(m) > 1]
    if keep:
        out_pl = pl
    else:
        out_pl = tuple(p if not isinstance(p, Shard) or p.dim < dim
                       else Replicate() if p.dim == dim
                       else Shard(p.dim - 1) for p in pl)
    if axes:
        reduce = _all_reduce(mesh, axes)

        def body(t):
            return split_fn(t, dim, reduce)
    else:
        def body(t):
            return plain_fn(t, dim)
    return local_map(body, out_placements=list(out_pl), in_placements=(pl,),
                     device_mesh=mesh)(x)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax(x, dim)``. A DTensor keeps its placements: where
    mesh axes of size > 1 split ``dim``, each rank's block is normalised
    by the global maximum and sum (two all-reduces over those axes, MAX
    then SUM, of the statistic's shape; the backward one more SUM), and
    the axis is never gathered; else torch's softmax runs on each shard."""
    if not isinstance(x, DTensor):
        return torch.softmax(x, dim)
    return _over_axis(x, dim % x.ndim, block_softmax, torch.softmax,
                      keep=True)


def logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.logsumexp(x, dim)``. A DTensor's result drops ``dim`` and
    keeps every other placement: where mesh axes of size > 1 split
    ``dim``, from each block's maximum and sum of exponentials (two
    all-reduces over those axes, MAX then SUM; the backward is local),
    never gathering the axis; else torch's logsumexp on each shard."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim)
    return _over_axis(x, dim % x.ndim, block_logsumexp,
                      torch.logsumexp, keep=False)


__all__ = ["cumsum", "einsum", "logsumexp", "reshape", "softmax"]
