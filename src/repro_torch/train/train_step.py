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
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import TrainConfig
from ..models.lm import Model
from ..models.spec import tree_leaves, tree_map, tree_unflatten, wide
from ..optim.optimizer import make_optimizer

F32 = torch.float32


def xent_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) float32 (float64 for a
    float64 model), targets (B,S) integer."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, _ = model.forward(params, batch)
        return xent_loss(logits.to(wide(logits.dtype)), batch["targets"])
    return loss_fn


def _split_microbatches(batch, n: int) -> list:
    """``n`` microbatches, each a slice of every input's first axis
    (encoder frames and patch embeddings split on batch too)."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
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
            grads = torch.autograd.grad(loss, tree_leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), list(grads)

    def grad_fn(params, batch):
        n = tc.microbatches
        if n > 1:
            loss = torch.zeros((), dtype=F32,
                               device=tree_leaves(params)[0].device)
            grads = [torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                     for p in tree_leaves(params)]
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
    ``mlp.wi`` and its square would take 4.3 GB)."""
    def sum_sq(g):
        acc = wide(g.dtype)
        return sum(torch.sum(torch.square(c.to(acc)))
                   for c in g.reshape(-1).split(_NORM_CHUNK))
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
