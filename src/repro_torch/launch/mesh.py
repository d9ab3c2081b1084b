"""Device meshes with the production axis names, the port of
``src/repro/launch/mesh.py``.

Single pod: 256 devices as (data=16, model=16). Multi-pod: 512 as
(pod=2, data=16, model=16). A function, not a module constant: importing
this module touches no device.
"""
from __future__ import annotations

import math

import torch

from ..core.engine import resolve_device
from ..distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh over the visible CUDA devices; raises when
    there are fewer than its 256 (or 512) devices, as ``jax.make_mesh``
    does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {need} devices; {have} CUDA devices are "
                         f"visible")
    devices = [torch.device("cuda", i) for i in range(need)]
    return Mesh(tuple(devices), axes, dict(zip(axes, shape)))


def make_local_mesh(device="cuda") -> Mesh:
    """One device with the production axis names (data=1, model=1), on
    the card unless ``device`` says otherwise; every sharding constraint
    is the identity on it."""
    dev = resolve_device(device)
    return Mesh((dev,), ("data", "model"), {"data": 1, "model": 1})


__all__ = ["make_local_mesh", "make_production_mesh"]
