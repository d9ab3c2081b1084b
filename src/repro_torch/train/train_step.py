"""Loss + train step: remat, microbatch gradient accumulation, optimizer;
the port of ``src/repro/train/train_step.py``.

``make_train_step(model, tc)`` returns ``(train_step, opt)``, where
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
returns new trees, as the reference's pure function does. Gradients are
``torch.autograd.grad`` over the leaves of the parameter tree; with
``tc.microbatches > 1`` the batch is split on its first axis and the
gradients are accumulated in the parameters' dtype (bfloat16 for a
bfloat16 model, as the reference's ``zeros(p.shape, p.dtype)``), then
loss and gradients are divided by the count.

On DTensor parameters (a process-group mesh) each gradient is
redistributed to its parameter's placements as it leaves autograd: a
``Partial`` sum over 'data' becomes the data-parallel all-reduce, or the
reduce-scatter of an FSDP-sharded parameter. The gradient norm sums each
rank's shards once. The loss over a vocab split across 'model' is
vocab-parallel (:func:`xent_loss`): no rank holds a whole row of logits.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import TrainConfig
from ..distributed.sharding import as_dtensor, redistribute, shard_offset
from ..distributed.spmd import logsumexp, reshape
from ..models.lm import Model
from ..models.spec import tree_leaves, tree_map, tree_unflatten, wide
from ..optim.optimizer import make_optimizer

F32 = torch.float32


def xent_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) float32 (float64 for a
    float64 model), targets (B,S) integer. On logits whose vocab is split
    over mesh axes it is vocab-parallel (Megatron's cross-entropy): ``logz``
    from each rank's maximum and sum (:func:`.spmd.logsumexp`) and the
    target's logit from each rank's block (:func:`_gold_sharded`), never
    gathering the vocab."""
    logz = logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        gold = _gold_sharded(logits, targets)
    else:
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _gold_sharded(logits: DTensor, targets) -> DTensor:
    """The target's logit of every token, from logits whose vocab axis
    may be split over mesh axes. DTensor has no sharding strategy for a
    ``gather`` along a split axis, so each rank reads the targets that
    fall in its own block of the vocab (zero for the rest) and the blocks
    add up: the result is a ``Partial`` sum over the mesh axes that split
    the vocab (Megatron's vocab-parallel cross-entropy). Its other
    placements are the logits'."""
    from torch.distributed.tensor.experimental import local_map
    last = logits.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim == last
             for p in logits.placements]
    tgt_pl = tuple(Replicate() if v else p
                   for v, p in zip(vocab, logits.placements))
    out_pl = tuple(Partial() if v else p
                   for v, p in zip(vocab, logits.placements))
    targets = as_dtensor(targets, logits.device_mesh)
    targets = redistribute(targets.long(), tgt_pl)
    v0 = shard_offset(logits, last)

    def local(lg, tg):
        idx = tg - v0
        inside = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(inside, g[..., 0], torch.zeros((), dtype=lg.dtype,
                                                          device=lg.device))
    return local_map(local, out_placements=list(out_pl),
                     in_placements=(logits.placements, tgt_pl),
                     device_mesh=logits.device_mesh)(logits, targets)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, _ = model.forward(params, batch)
        loss = xent_loss(logits.to(wide(logits.dtype)), batch["targets"])
        if isinstance(loss, DTensor):    # a pending sum reduced before grad
            loss = redistribute(loss, (Replicate(),) * loss.device_mesh.ndim)
        return loss
    return loss_fn


def _split_microbatches(batch, n: int) -> list:
    """``n`` microbatches, each a slice of every input's first axis
    (encoder frames and patch embeddings split on batch too): microbatch
    ``i`` holds rows ``i·b/n`` to ``(i+1)·b/n`` of the global batch, as
    in the reference (the MoE's capacity per token group depends on
    which rows route together). A DTensor input split over its batch is
    gathered for that (``spmd.reshape``); the model's first constraint
    puts each microbatch's rows back over the batch axes."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} "
                             f"microbatches")
        return reshape(x, n, b // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_grad_fn(model: Model, tc: TrainConfig) -> Callable:
    """``grad_fn(params, batch) -> (loss, grads)``: the loss and a tree of
    gradients like ``params``, accumulated over ``tc.microbatches``; sets
    ``model.remat = tc.remat``, as the reference's ``make_train_step``
    does."""
    model.remat = tc.remat
    loss_fn = make_loss_fn(model)

    def value_and_grad(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
            loss = loss_fn(live, batch)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads = [redistribute(g, p.placements) if isinstance(p, DTensor)
                 else g for g, p in zip(grads, leaves)]
        loss = loss.detach()
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()        # a scalar: every rank's value
        return loss, grads

    def grad_fn(params, batch):
        n = tc.microbatches
        if n > 1:
            loss = torch.zeros((), dtype=F32,
                               device=tree_leaves(params)[0].device)
            grads = [torch.zeros_like(p) for p in tree_leaves(params)]
            for mb in _split_microbatches(batch, n):
                mb_loss, mb_grads = value_and_grad(params, mb)
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g)
                loss = loss + mb_loss
            loss = loss / n
            grads = [g.div_(n) for g in grads]
        else:
            loss, grads = value_and_grad(params, batch)
        return loss, tree_unflatten(params, grads)

    return grad_fn


_NORM_CHUNK = 1 << 26   # elements widened at once by grad_norm


def grad_norm(grads) -> torch.Tensor:
    """The root of the sum of squares over every leaf, in leaf order, in
    float32 (float64 for float64 gradients). Each leaf is widened
    ``_NORM_CHUNK`` elements at a time (a whole float32 copy of olmo-1b's
    ``mlp.wi`` and its square would take 4.3 GB). A DTensor leaf sums
    its local shard and adds the shards over the mesh axes that split it
    (an all-reduce of one number); a replicated copy counts once."""
    def local_sum_sq(g):
        acc = wide(g.dtype)
        return sum(torch.sum(torch.square(c.to(acc)))
                   for c in g.reshape(-1).split(_NORM_CHUNK))

    def sum_sq(g):
        if not isinstance(g, DTensor):
            return local_sum_sq(g)
        pl = [Partial() if isinstance(p, Shard) else Replicate()
              for p in g.placements]
        return DTensor.from_local(local_sum_sq(g.to_local()), g.device_mesh,
                                  pl, run_check=False).full_tensor()
    return torch.sqrt(sum(sum_sq(g) for g in tree_leaves(grads)))


def make_train_step(model: Model, tc: TrainConfig):
    """``(train_step, opt)``; sets ``model.remat = tc.remat``, as the
    reference does. ``train_step(params, opt_state, batch, mark=None)``:
    ``mark``, when given, is called between the gradients (with their
    norm) and the optimizer's update, for a caller that times the two."""
    grad_fn = make_grad_fn(model, tc)
    opt = make_optimizer(tc)

    def train_step(params, opt_state, batch,
                   mark: Optional[Callable[[], None]] = None):
        loss, grads = grad_fn(params, batch)
        gnorm = grad_norm(grads)
        if mark is not None:
            mark()
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt


__all__ = ["grad_norm", "make_grad_fn", "make_loss_fn", "make_train_step",
           "xent_loss"]
