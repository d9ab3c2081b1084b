"""Training (the port of ``src/repro/train``): loss, gradients with
remat and microbatches, and the optimizer step."""
from .train_step import (grad_norm, make_grad_fn, make_loss_fn,
                         make_train_step, xent_loss)

__all__ = ["grad_norm", "make_grad_fn", "make_loss_fn", "make_train_step",
           "xent_loss"]
