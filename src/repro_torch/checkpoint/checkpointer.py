"""Async, sharded, resumable checkpointing, the port of
``src/repro/checkpoint/checkpointer.py``, in the reference's layout:

    <dir>/step_<N>/leaf_<i>.npy   one file per tree leaf, whole
    <dir>/step_<N>/manifest.json  step, structure, leaf count, extra

* ``save`` snapshots every leaf to the host synchronously (bfloat16 as
  float32: numpy has no bfloat16), then writes on a background thread;
  ``wait`` joins it and raises what the write raised.
* ``restore(like, step, shardings)`` casts each leaf to the dtype of
  ``like``'s leaf and places it as ``shardings`` says (a tree of
  :class:`~repro_torch.distributed.sharding.NamedSharding`), else as
  ``like``'s leaf is placed: a job restarted on another mesh reshards
  as it restores.
* Writes go to ``.tmp_step_<N>`` and are renamed into place; steps past
  the newest ``keep`` are deleted.

Under ``torch.distributed`` every method is collective over the default
process group and every rank calls it alike. ``save`` gathers each
DTensor leaf whole (``full_tensor``), one leaf at a time, on the calling
thread; rank 0 keeps the host copies (plain leaves are taken from rank
0's value), and only rank 0 touches the directory: its background thread
writes files and nothing else. ``wait``, ``steps`` and ``latest_step``
hand rank 0's outcome to every rank; a failure on rank 0 (a write, a
snapshot, a read) raises on every rank. ``restore`` reads each file on
rank 0 and scatters its blocks to the ranks that hold them
(``distribute_tensor(..., src_data_rank=0)``); plain leaves are
broadcast. Save and restore hold at most one leaf whole on the device
beyond the state. Without a process group nothing is communicated.

Leaves are numbered in :func:`~repro_torch.models.spec.tree_leaves` order,
which is ``jax.tree.flatten``'s (dict keys sorted, ``NamedTuple`` fields in
order), so a checkpoint written by the reference restores here and one
written here restores in the reference, sharded or not. The manifest's
``treedef`` is a readable structure string (leaves as ``*``), not JAX's;
both sides check only ``n_leaves``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from ..models.spec import tree_leaves, tree_map, tree_unflatten


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (bfloat16 widened to float32 on the host),
    taken now."""
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def _rank() -> Optional[int]:
    """This process's rank in the default process group; ``None`` when
    there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return None


def _from_rank0(obj):
    """Rank 0's ``obj`` on every rank (itself without a process group)."""
    if _rank() is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _agree(err: Optional[BaseException], what: str) -> None:
    """Raise on every rank if rank 0 failed: rank 0 raises ``err``, the
    others a ``RuntimeError`` naming it."""
    said = _from_rank0(None if err is None
                       else f"{type(err).__name__}: {err}")
    if err is not None and _rank() in (None, 0):
        raise err
    if said is not None:
        raise RuntimeError(f"{what} failed on rank 0: {said}")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        if _rank() in (None, 0):
            os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # seconds the last background write took (rank 0; read after wait)
        self.write_s: Optional[float] = None

    # -- save -------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        self.wait()
        writer = _rank() in (None, 0)
        host, err = [], None
        for x in tree_leaves(tree):
            # every rank gathers every DTensor leaf, in leaf order
            full = x.full_tensor() if isinstance(x, DTensor) else x
            if writer and err is None:
                try:
                    host.append(_host(full))
                except Exception as e:  # noqa: BLE001 — raised on all ranks
                    err = e
            del full
        _agree(err, f"the snapshot of checkpoint step {step}")
        if writer:
            self._start_write(step, tree, host, extra)
        if block:
            self.wait()

    def _start_write(self, step, tree, host, extra):
        manifest = {
            "step": step,
            "treedef": repr(tree_map(lambda _: "*", tree)),
            "n_leaves": len(host),
            "extra": extra or {},
        }

        def write():
            try:
                t0 = time.perf_counter()
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                for i, arr in enumerate(host):
                    np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
                self.write_s = time.perf_counter() - t0
            except Exception as e:  # handed to wait(), which raises it
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the background write; raise what it raised (on every rank
        under a process group)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        _agree(err, "a checkpoint write")

    def _gc(self):
        steps = sorted(self._listed())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def _listed(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def steps(self):
        """The steps on disk (rank 0's list on every rank)."""
        return _from_rank0(self._listed() if _rank() in (None, 0) else None)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None):
        """``(tree, manifest)``: the tree of ``like``'s structure from disk,
        each leaf in the dtype of ``like``'s. ``shardings`` (a tree of
        ``NamedSharding`` of ``like``'s structure) places each leaf: a
        DTensor on a process-group mesh, else a plain tensor on the mesh's
        device. Without it, or where its entry is ``None``, a leaf takes
        ``like``'s leaf's placements and mesh, or its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        reader = _rank() in (None, 0)
        d = os.path.join(self.dir, f"step_{step}")
        manifest, err = None, None
        if reader:
            try:
                with open(os.path.join(d, "manifest.json")) as f:
                    manifest = json.load(f)
            except (OSError, ValueError) as e:
                err = e
        _agree(err, f"reading checkpoint step {step}")
        manifest = _from_rank0(manifest)
        leaves = tree_leaves(like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{manifest['n_leaves']} leaves; the tree to "
                             f"restore has {len(leaves)}")
        places = (tree_leaves(shardings, lambda s: hasattr(s, "spec"))
                  if shardings is not None else [None] * len(leaves))
        if len(places) != len(leaves):
            raise ValueError(f"{len(places)} shardings for {len(leaves)} "
                             f"leaves")
        out = []
        for i, (l, sh) in enumerate(zip(leaves, places)):
            arr, err = None, None
            if reader:
                try:
                    arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
                    if arr.shape != tuple(l.shape):
                        raise ValueError(f"leaf {i} of checkpoint step "
                                         f"{step} has shape {arr.shape}; "
                                         f"the tree's is {tuple(l.shape)}")
                except (OSError, ValueError) as e:
                    err = e
            _agree(err, f"reading leaf {i} of checkpoint step {step}")
            out.append(_place(arr, l, sh))
            del arr
        return tree_unflatten(like, out), manifest


def _place(arr: Optional[np.ndarray], like: torch.Tensor, sharding):
    """Rank 0's ``arr`` (``None`` on the other ranks) in ``like``'s dtype,
    placed by ``sharding`` or as ``like`` is."""
    dtype = like.dtype
    if sharding is not None:
        mesh, dm = sharding.mesh, sharding.mesh.device_mesh
        device, want = mesh.local_device, sharding.placements
        if dm is None and any(isinstance(p, Shard) and mesh.shape[a] > 1
                              for a, p in zip(mesh.axis_names, want)):
            raise ValueError(f"the mesh {dict(mesh.shape)} has no process "
                             f"group to split a leaf by {sharding.spec}")
    elif isinstance(like, DTensor):
        dm, want, device = (like.device_mesh, tuple(like.placements),
                            like.to_local().device)
    else:
        dm, device = None, like.device
    if arr is not None:
        full = torch.from_numpy(arr).to(device=device, dtype=dtype)
    else:
        full = torch.empty(like.shape, dtype=dtype, device=device)
    if dm is not None:
        if int(dm.mesh.flatten()[0]) != 0:
            raise ValueError("the mesh's first rank must be rank 0, the "
                             "one that reads the checkpoint")
        return distribute_tensor(full, dm, want, src_data_rank=0)
    if _rank() is not None:
        dist.broadcast(full, src=0)
    return full


__all__ = ["Checkpointer"]
