"""Async, resumable checkpointing, the port of
``src/repro/checkpoint/checkpointer.py``, in the reference's layout:

    <dir>/step_<N>/leaf_<i>.npy   one file per tree leaf
    <dir>/step_<N>/manifest.json  step, structure, leaf count, extra

* ``save`` snapshots every leaf to the host synchronously (bfloat16 as
  float32: numpy has no bfloat16), then writes on a background thread;
  ``wait`` joins it and raises what the write raised.
* ``restore(like, step)`` casts each leaf to the dtype of ``like``'s leaf
  and puts it on that leaf's device.
* Writes go to ``.tmp_step_<N>`` and are renamed into place; steps past
  the newest ``keep`` are deleted.

Leaves are numbered in :func:`~repro_torch.models.spec.tree_leaves` order,
which is ``jax.tree.flatten``'s (dict keys sorted, ``NamedTuple`` fields in
order), so a checkpoint written by the reference restores here and one
written here restores in the reference. The manifest's ``treedef`` is a
readable structure string (leaves as ``*``), not JAX's; both sides check
only ``n_leaves``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.spec import tree_leaves, tree_map, tree_unflatten


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (bfloat16 widened to float32), taken now."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.to("cpu", copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- save -------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        self.wait()
        host = [_host(x) for x in tree_leaves(tree)]
        manifest = {
            "step": step,
            "treedef": repr(tree_map(lambda _: "*", tree)),
            "n_leaves": len(host),
            "extra": extra or {},
        }

        def write():
            try:
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
            except Exception as e:  # handed to wait(), which raises it
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None):
        """``(tree, manifest)``: the tree of ``like``'s structure from disk,
        each leaf in the dtype and on the device of ``like``'s."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = tree_leaves(like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{manifest['n_leaves']} leaves; the tree to "
                             f"restore has {len(leaves)}")
        arrs = [torch.from_numpy(np.load(os.path.join(d, f"leaf_{i}.npy")))
                .to(device=l.device, dtype=l.dtype)
                for i, l in enumerate(leaves)]
        return tree_unflatten(like, arrs), manifest


__all__ = ["Checkpointer"]
