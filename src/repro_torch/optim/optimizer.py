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

On DTensor parameters the moments are placed as the reference's dry run
places them (``opt_state_shardings``): an int8 moment's codes follow
their parameter and its scale drops the last dim's split; a float32
moment takes ZeRO-1, its parameter's placement with the first
unsplit dim that divides the 'data' axis split over it as well. The
update computes in those placements; the new parameter is redistributed
to its own (ZeRO-1's all-gather of the update over 'data').
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import TrainConfig
from ..distributed.sharding import dtensor_zeros, redistribute
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


def state_placements(p: DTensor, int8: bool):
    """The placements of ``p``'s moments: ``(q, scale)`` for int8 codes,
    one tuple for a float32 moment."""
    pl = tuple(p.placements)
    if int8:
        last = p.ndim - 1
        scale = tuple(Replicate() if isinstance(x, Shard) and x.dim == last
                      else x for x in pl)
        return pl, scale
    mesh = p.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if "data" not in names:
        return pl
    d = names.index("data")
    if not isinstance(pl[d], Replicate):
        return pl
    split = {x.dim for x in pl if isinstance(x, Shard)}
    dsize = mesh.size(d)
    for i, n in enumerate(p.shape):
        if i not in split and n > 0 and n % dsize == 0:
            return pl[:d] + (Shard(i),) + pl[d + 1:]
    return pl


def _placed(x: torch.Tensor, like: torch.Tensor, want=None):
    """``x`` redistributed to ``want`` (default: ``like``'s placements)
    when ``like`` is a DTensor; ``x`` itself otherwise."""
    if not isinstance(like, DTensor):
        return x
    return redistribute(x, tuple(want or like.placements))


@dataclasses.dataclass
class AdamW:
    tc: TrainConfig

    def init(self, params):
        """Zero moments beside every parameter, on its device (a DTensor
        parameter's moments are DTensors placed by
        :func:`state_placements`), and the step count (a 0-d int32 tensor
        on the first parameter's device)."""
        int8 = self.tc.opt_state_dtype == "int8"

        def one(p):
            if isinstance(p, DTensor):
                return _dtensor_moments(p, int8)
            z = torch.zeros(p.shape, dtype=F32, device=p.device)
            if int8:
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
            gf = _placed(g.to(F32), mu["m"].q if int8 else mu["m"])
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
            pf = _placed(p.to(F32), upd)
            new_p = (pf - lr * (upd + tc.weight_decay * pf)).to(p.dtype)
            new_p = _placed(new_p, p)
            if int8:
                return new_p, {"m": _requantize(m, mu["m"]),
                               "v": _requantize(torch.sqrt(v), mu["v"])}
            return new_p, {"m": _placed(m, mu["m"]), "v": _placed(v, mu["v"])}

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


def _dtensor_moments(p: DTensor, int8: bool) -> dict:
    """Zero moments of a DTensor parameter, each rank allocating only its
    shards on the parameter's device (:func:`state_placements`)."""
    mesh = p.device_mesh
    dev = p.to_local().device
    shape = tuple(p.shape)

    def z(shape, dtype, pl):
        return dtensor_zeros(shape, dtype, mesh, pl, dev)
    if int8:
        qpl, spl = state_placements(p, True)
        sshape = shape[:-1] + (1,) if shape else ()

        def q():   # _quantize of zeros: zero codes, a scale of 1e-12
            return QTensor(z(shape, torch.int8, qpl),
                           z(sshape, F32, spl) + 1e-12)
        return {"m": q(), "v": q()}
    pl = state_placements(p, False)
    return {"m": z(shape, F32, pl), "v": z(shape, F32, pl)}


def _requantize(x: torch.Tensor, like: QTensor) -> QTensor:
    """``_quantize(x)`` with the codes and scale in ``like``'s
    placements (plain tensors where ``like`` holds plain tensors)."""
    qt = _quantize(x)
    return QTensor(_placed(qt.q, like.q), _placed(qt.scale, like.scale))


def make_optimizer(tc: TrainConfig) -> AdamW:
    if tc.optimizer != "adamw":
        raise ValueError(f"optimizer {tc.optimizer!r}: only 'adamw' exists")
    return AdamW(tc)


__all__ = ["AdamW", "QTensor", "make_optimizer"]
