"""Logical-axis sharding rules resolved against a device mesh.

The port of ``src/repro/distributed/sharding.py``. Every parameter spec and
activation constraint names *logical* axes ('batch', 'heads', 'mlp', …).
``RULES`` maps them to mesh axes; resolution is divisibility-aware — a
tensor dim that does not divide its mesh axis falls back to replication
(whisper's 6 heads on a 16-way model axis, an un-padded vocab), a mesh axis
shards at most one dim (the leftmost wins), and a rule may name a tuple of
mesh axes (``batch`` over ``("pod", "data")``).

The port's mesh is :class:`Mesh`: torch devices laid out row-major over
named axes. Nothing here places a tensor: the tile axis of
:mod:`.mesh_exec` is the one placement the port executes. A model tensor
that a mesh would really split (tensor or data parallelism across cards)
is refused by :func:`constrain` with ``NotImplementedError``, rather than
silently computed unsplit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

# logical axis -> mesh axis (or tuple of mesh axes) — ACTIVATIONS
RULES = {
    "batch": ("pod", "data"),
    "experts": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "d_inner": "model",          # mamba inner dim (TP)
    "cache_seq": "model",        # decode KV cache sequence axis (split-K)
    "tiles": "tiles",            # MatPIM packed tile-chunk axis (mesh_exec)
    "embed": None,
    "head_dim": None,
    "layers": None,
    "seq": None,
}

# PARAMETERS additionally FSDP-shard the embed dim over 'data' (ZeRO-3 /
# MaxText hybrid): TP over 'model' + fully-sharded params over 'data'.
PARAM_RULES = {**RULES, "embed": "data"}


@dataclasses.dataclass
class Mesh:
    """Torch devices laid out row-major over named axes.

    ``shape`` maps each axis name to its size, in ``axis_names`` order;
    ``devices`` holds ``prod(sizes)`` entries (a device may repeat: slots
    on one card).

    >>> m = Mesh((torch.device("cpu"),) * 4, ("data", "model"),
    ...          {"data": 2, "model": 2})
    >>> m.size, m.shape["model"]
    (4, 2)
    """

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    def __post_init__(self):
        self.devices = tuple(torch.device(d) for d in self.devices)
        self.axis_names = tuple(self.axis_names)
        if tuple(self.shape) != self.axis_names:
            raise ValueError(f"mesh shape {self.shape} does not follow the "
                             f"axes {self.axis_names}")
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement: the mesh and one entry per dim (a mesh axis,
    a tuple of mesh axes, or ``None`` for replicated)."""

    mesh: Mesh
    spec: tuple


_ctx = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Activate a mesh (+ optional rule overrides) for this thread's
    :func:`constrain` and ``engine.execute`` calls."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, {**RULES, **(rules or {})})
    try:
        yield
    finally:
        _ctx.state = prev


def current_mesh() -> Optional[Mesh]:
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(axis, 1)


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: Optional[dict] = None) -> tuple:
    """Logical axes -> one entry per dim, dropping non-divisible
    assignments. ``mesh`` needs only ``axis_names`` and a ``shape``
    mapping.

    >>> m = Mesh((torch.device("cpu"),) * 4, ("data", "model"),
    ...          {"data": 2, "model": 2})
    >>> resolve_spec(("batch", None, "heads"), (8, 3, 6), m)
    (('data',), None, 'model')
    >>> resolve_spec(("experts", "mlp"), (3, 4), m)   # 3 % 2: replicate
    (None, 'model')
    """
    rules = rules or (getattr(_ctx, "state", None) or (None, RULES))[1]
    parts = []
    used = set()  # a mesh axis may shard at most one dim (leftmost wins)
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            parts.append(None)
            continue
        if isinstance(mesh_axis, (tuple, list)):
            mesh_axis = tuple(a for a in mesh_axis
                              if a in mesh.axis_names and a not in used)
            if not mesh_axis:
                parts.append(None)
                continue
        elif mesh_axis not in mesh.axis_names or mesh_axis in used:
            parts.append(None)
            continue
        if dim % _mesh_axis_size(mesh, mesh_axis) != 0:
            parts.append(None)  # indivisible -> replicate
        else:
            parts.append(mesh_axis)
            used.update(mesh_axis if isinstance(mesh_axis, tuple)
                        else (mesh_axis,))
    return tuple(parts)


def named_sharding(axes: Sequence[Optional[str]], shape: Sequence[int],
                   mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh or current_mesh()
    return NamedSharding(mesh, resolve_spec(axes, shape, mesh))


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]):
    """The reference's sharding constraint by logical axes: the identity
    without a mesh, and on a mesh where the resolved placement splits
    nothing: every mesh axis it assigns has size 1 (a ``tiles`` mesh
    assigns none of a model tensor's axes). A placement that would split
    ``x`` across devices is tensor or data parallelism over cards, which
    the port does not execute: it raises ``NotImplementedError``."""
    st = getattr(_ctx, "state", None)
    if not st or st[0] is None:
        return x
    mesh, rules = st
    spec = resolve_spec(axes, x.shape, mesh, rules)
    split = [(dim, ax) for dim, ax in enumerate(spec)
             if _mesh_axis_size(mesh, ax) > 1]
    if split:
        raise NotImplementedError(
            f"the mesh {dict(mesh.shape)} would split a tensor of shape "
            f"{tuple(x.shape)} (logical axes {tuple(axes)}) over dims "
            f"{split}: tensor parallelism across devices is not ported to "
            f"repro_torch")
    return x


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


def tree_shardings(axes_tree, abstract_tree, mesh: Optional[Mesh] = None,
                   params: bool = False):
    """Map a tree of logical-axes tuples and a tree of tensors of the same
    structure to a tree of :class:`NamedSharding`\\ s.

    ``params=True`` applies ``PARAM_RULES`` (FSDP over 'data' on the embed
    dim); ``use_mesh`` rule overrides apply to activations and caches
    only, as in the reference.
    """
    from ..models.spec import tree_leaves, tree_map
    mesh = mesh or current_mesh()
    st = getattr(_ctx, "state", None)
    rules = PARAM_RULES if params else (st[1] if st else RULES)
    axes = tree_leaves(axes_tree, _is_axes)
    n = len(tree_leaves(abstract_tree))
    if len(axes) != n:
        raise ValueError(f"{len(axes)} axes for {n} tensors")
    it = iter(axes)
    return tree_map(lambda arr: NamedSharding(
        mesh, resolve_spec(next(it), arr.shape, mesh, rules)),
        abstract_tree)


__all__ = ["Mesh", "NamedSharding", "PARAM_RULES", "RULES", "constrain",
           "current_mesh", "named_sharding", "resolve_spec",
           "tree_shardings", "use_mesh"]
