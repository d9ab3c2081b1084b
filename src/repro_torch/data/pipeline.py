"""Data pipeline: deterministic, step-indexed, resumable; the port of
``src/repro/data/pipeline.py``.

Every batch is generated from (seed, step) alone — no iterator state — so
a restarted job resumes bit-identically from the checkpointed step. The
sources are numpy on the host and give the reference's batches bit for
bit:

* ``SyntheticLM``  — zipfian tokens (default for benchmarks and smoke runs)
* ``FileTokens``   — memory-mapped int32 token file, strided by step

``make_global_batch`` puts a host batch on the mesh: tokens as int64 (the
port's token dtype), floats in the model's dtype, on one device as plain
tensors, or split over ``("pod", "data")`` as DTensors on a process-group
mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import RULES, distribute, placements, resolve_spec
from ..models.spec import torch_dtype


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-distributed tokens; next-token targets; deterministic per step."""
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2

    def at_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        V = self.cfg.vocab
        toks = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1))
        toks = np.clip(toks, 1, V - 1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.family == "encdec":
            out["frames"] = (rng.standard_normal(
                (self.batch, self.cfg.enc_seq, self.cfg.d_model)) * 0.1
            ).astype(np.float32)
        if self.cfg.family == "vlm":
            out["patch_embeds"] = (rng.standard_normal(
                (self.batch, 256, self.cfg.d_model)) * 0.1).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.at_step(step)
            step += 1


@dataclasses.dataclass
class FileTokens:
    """Token stream from a flat int32 file, deterministic strides."""
    path: str
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __post_init__(self):
        self.data = np.memmap(self.path, dtype=np.int32, mode="r")

    def at_step(self, step: int) -> Dict[str, np.ndarray]:
        n = len(self.data) - self.seq - 1
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, n, size=self.batch)
        toks = np.stack([self.data[s:s + self.seq + 1] for s in starts])
        toks = np.clip(toks, 0, self.cfg.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_global_batch(batch_np: Dict[str, np.ndarray], mesh,
                      dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Host numpy -> tensors on the mesh: integer arrays as int64, float
    arrays in ``dtype``. On a mesh with no process group (one device,
    ``launch.mesh.make_local_mesh``) they are plain tensors on its device.
    On a process-group mesh every rank holds the whole host batch (it is
    made from ``(seed, step)`` alone) and keeps its rows: a DTensor
    ``Shard(0)`` over the ``("pod", "data")`` axes the mesh has and
    ``Replicate`` over ``model``, as the reference's
    ``P(("pod", "data"))`` places it. A batch that does not divide those
    axes is replicated, as ``resolve_spec`` replicates an indivisible
    dim."""
    dm = getattr(mesh, "device_mesh", None)
    if dm is None and len(mesh.devices) != 1:
        raise ValueError(f"a mesh of {len(mesh.devices)} devices with no "
                         f"process group cannot hold a split batch")
    dev = mesh.local_device
    dtype = torch_dtype(dtype)
    out = {}
    for k, v in batch_np.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = (t.long() if np.issubdtype(v.dtype, np.integer)
             else t.to(dtype)).to(dev)
        if dm is not None:
            spec = resolve_spec(("batch",) + (None,) * (t.ndim - 1),
                                t.shape, mesh, RULES)
            t = distribute(t, placements(spec, mesh), mesh)
        out[k] = t
    return out


__all__ = ["FileTokens", "SyntheticLM", "make_global_batch"]
