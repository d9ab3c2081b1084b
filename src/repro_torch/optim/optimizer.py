"""AdamW with optional int8-quantized moments + cosine schedule, the port
of ``src/repro/optim/optimizer.py``.

The reference's arithmetic, step for step: float32 moments, bias
correction with the incremented step, the new parameter computed in
float32 and cast back to the parameter's dtype. In the int8 path each
moment is stored as int8 codes with a float32 scale per last axis
(``max|x| / 127 + 1e-12``, codes rounded half to even as ``jnp.round``
does), ``v`` as ``sqrt(v)``, and the update is clipped to ±5.

``update`` returns new trees and leaves its arguments as they were, as
the reference's pure function does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..configs.base import TrainConfig
from ..models.spec import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


class QTensor(NamedTuple):
    """int8-quantized tensor: ``q`` has the parameter's shape, ``scale``
    is per last axis (``shape[:-1] + (1,)``; a 0-d scale for a 0-d
    tensor)."""
    q: torch.Tensor
    scale: torch.Tensor


def _quantize(x: torch.Tensor) -> QTensor:
    if x.ndim == 0:
        x = x[None]
        scale = x.abs().max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return QTensor(q[0], scale.to(F32))
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale.to(F32))


def _dequantize(qt: QTensor, shape) -> torch.Tensor:
    return (qt.q.to(F32) * qt.scale).reshape(shape)


@dataclasses.dataclass
class AdamW:
    tc: TrainConfig

    def init(self, params):
        """Zero moments beside every parameter, on its device, and the
        step count (a 0-d int32 tensor on the first parameter's device)."""
        def one(p):
            z = torch.zeros(p.shape, dtype=F32, device=p.device)
            if self.tc.opt_state_dtype == "int8":
                return {"m": _quantize(z), "v": _quantize(z)}
            return {"m": z, "v": torch.zeros_like(z)}
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(one, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def abstract_init(self, abstract_params):
        """The state's shapes and dtypes as ``meta`` tensors (nothing is
        allocated)."""
        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def one(p):
            shape = tuple(p.shape)
            if self.tc.opt_state_dtype == "int8":
                sshape = shape[:-1] + (1,) if shape else ()
                return {"m": QTensor(meta(shape, torch.int8),
                                     meta(sshape, F32)),
                        "v": QTensor(meta(shape, torch.int8),
                                     meta(sshape, F32))}
            return {"m": meta(shape, F32), "v": meta(shape, F32)}
        return {"mu": tree_map(one, abstract_params),
                "step": meta((), torch.int32)}

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """100 linear warmup steps, then a cosine over 10 000 steps, in
        float32; ``step`` is an int32 tensor."""
        warmup = 100.0
        base = self.tc.lr
        lr = torch.where(step < warmup, base * (step + 1) / warmup,
                         base * 0.5 * (1 + torch.cos(math.pi * torch.clamp(
                             (step - warmup) / 10000.0, max=1.0))))
        return lr.to(F32)

    def update(self, grads, state, params):
        """``(new_params, new_state)``: one AdamW step over the leaves of
        ``grads`` in tree order."""
        tc = self.tc
        int8 = tc.opt_state_dtype == "int8"
        step = state["step"] + 1
        lr = self.lr_at(step)
        b1, b2 = tc.beta1, tc.beta2
        bc1 = 1 - b1 ** step.to(F32)
        bc2 = 1 - b2 ** step.to(F32)

        def one(g, mu, p):
            gf = g.to(F32)
            if int8:
                # v is stored as sqrt(v) (halves the dynamic range a linear
                # int8 code must span); updates are clipped: both standard
                # 8-bit-Adam stabilizations
                m = _dequantize(mu["m"], g.shape)
                v = torch.square(_dequantize(mu["v"], g.shape))
            else:
                m, v = mu["m"], mu["v"]
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            upd = (m / bc1) / (torch.sqrt(v / bc2) + tc.eps)
            if int8:
                upd = torch.clamp(upd, -5.0, 5.0)
            pf = p.to(F32)
            new_p = (pf - lr * (upd + tc.weight_decay * pf)).to(p.dtype)
            if int8:
                return new_p, {"m": _quantize(m),
                               "v": _quantize(torch.sqrt(v))}
            return new_p, {"m": m, "v": v}

        flat_g = tree_leaves(grads)
        flat_p = tree_leaves(params)
        # the moments of one parameter are a subtree ({"m", "v"}) in the
        # state's "mu": take them whole, one per gradient leaf
        flat_mu = tree_leaves(state["mu"], lambda x: isinstance(x, dict)
                              and set(x) == {"m", "v"})
        if not len(flat_g) == len(flat_mu) == len(flat_p):
            raise ValueError(f"{len(flat_g)} gradients, {len(flat_mu)} "
                             f"moments and {len(flat_p)} parameters")
        outs = [one(g, mu, p) for g, mu, p in zip(flat_g, flat_mu, flat_p)]
        new_params = tree_unflatten(grads, [o[0] for o in outs])
        new_mu = tree_unflatten(grads, [o[1] for o in outs])
        return new_params, {"mu": new_mu, "step": step}


def make_optimizer(tc: TrainConfig) -> AdamW:
    if tc.optimizer != "adamw":
        raise ValueError(f"optimizer {tc.optimizer!r}: only 'adamw' exists")
    return AdamW(tc)


__all__ = ["AdamW", "QTensor", "make_optimizer"]
