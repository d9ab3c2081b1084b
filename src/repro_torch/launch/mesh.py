"""Device meshes with the production axis names, the port of
``src/repro/launch/mesh.py``.

Single pod: 256 ranks as (data=16, model=16). Multi-pod: 512 as
(pod=2, data=16, model=16); the 'pod' axis is pure data parallelism, so
only the gradient all-reduce (optionally 1-bit compressed,
``optim/grad_compress.py``) crosses it. A mesh over more than one device
is a ``torch.distributed`` ``DeviceMesh`` over an initialized process
group, one rank per slot: real (``torchrun``, gloo ranks in the tests) or
a fake group of ``meta`` shapes (``launch/dryrun.py``). Functions, not
module constants: importing this module touches no device.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from ..core.engine import resolve_device
from ..distributed.sharding import Mesh


def _rank_device(device_type: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: one card per rank, round robin over the
    visible cards (``torchrun`` on one host), else the device type."""
    if device_type == "cuda":
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return torch.device(device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> Mesh:
    """A mesh of ``shape`` over named ``axes`` across every rank of the
    initialized process group (``prod(shape)`` ranks, row-major), with
    the ``DeviceMesh`` it stands for: 2×2 ``("data", "model")`` or 2×1×2
    with ``pod`` on gloo CPU ranks, 1×1 on a one-rank NCCL group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    need = math.prod(shape)
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 0)
    if have != need:
        raise ValueError(f"a mesh {dict(zip(axes, shape))} needs {need} "
                         f"devices, one rank each; the process group has "
                         f"{have} ranks")
    dm = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    devices = tuple(_rank_device(device_type, r) for r in range(need))
    return Mesh(devices, axes, dict(zip(axes, shape)), device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """The production mesh over an initialized process group of 256 (or
    512) ranks, real or fake; raises ``ValueError`` when no such group is
    up, as ``jax.make_mesh`` does below its device count."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_from_env(device="cuda") -> Mesh:
    """The launchers' mesh. Under ``torchrun`` (``WORLD_SIZE`` set) it
    joins the process group (NCCL on the card, one card per
    ``LOCAL_RANK``; gloo on the CPU) and spans every rank: the production
    mesh at 256 or 512 ranks, else ``(data=world, model=1)``, pure data
    parallelism. Otherwise the one-device mesh (:func:`make_local_mesh`),
    where the reference takes its production mesh."""
    if "WORLD_SIZE" not in os.environ:
        return make_local_mesh(device)
    dev = resolve_device(device)
    world = int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if world in (256, 512):
        return make_production_mesh(multi_pod=world == 512,
                                    device_type=dev.type)
    return make_mesh((world, 1), ("data", "model"), dev.type)


def make_local_mesh(device="cuda") -> Mesh:
    """One device with the production axis names (data=1, model=1), on
    the card unless ``device`` says otherwise; every sharding constraint
    is the identity on it."""
    dev = resolve_device(device)
    return Mesh((dev,), ("data", "model"), {"data": 1, "model": 1})


__all__ = ["make_local_mesh", "make_mesh", "make_production_mesh",
           "mesh_from_env"]
