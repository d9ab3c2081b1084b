"""Logical-axis sharding rules resolved against a device mesh.

The port of ``src/repro/distributed/sharding.py``. Every parameter spec and
activation constraint names *logical* axes ('batch', 'heads', 'mlp', …).
``RULES`` maps them to mesh axes; resolution is divisibility-aware — a
tensor dim that does not divide its mesh axis falls back to replication
(whisper's 6 heads on a 16-way model axis, an un-padded vocab), a mesh axis
shards at most one dim (the leftmost wins), and a rule may name a tuple of
mesh axes (``batch`` over ``("pod", "data")``).

The port's mesh is :class:`Mesh`: named axes over torch devices. Two
kinds exist:

* a mesh over a ``torch.distributed`` process group (one rank per slot,
  ``launch.mesh.make_mesh``) carries the ``DeviceMesh`` it stands for.
  Tensors on it are DTensors: :func:`placements` turns a resolved spec
  into their placements, :func:`distribute_tree` places a tree of
  parameters, caches or inputs, and :func:`constrain` redistributes an
  activation where the reference's ``with_sharding_constraint`` pins it.
  :func:`use_mesh` on such a mesh lets plain tensors made inside the
  model (positions, masks, a scan's zero carry) join DTensor operations as
  replicated values.
* a mesh with no process group: the tile mesh of :mod:`.mesh_exec` (slots
  that may repeat a device) and the one-device mesh
  (``launch.mesh.make_local_mesh``). Every sharding constraint on it is the
  identity where its resolved placement splits nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

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
    on one card). ``device_mesh`` is the ``DeviceMesh`` over a process
    group that the mesh stands for (one rank per slot, ``devices[r]``
    rank ``r``'s device), or ``None``.

    >>> m = Mesh((torch.device("cpu"),) * 4, ("data", "model"),
    ...          {"data": 2, "model": 2})
    >>> m.size, m.shape["model"]
    (4, 2)
    """

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device_mesh: Optional[object] = dataclasses.field(default=None,
                                                      compare=False)

    def __post_init__(self):
        self.devices = tuple(torch.device(d) for d in self.devices)
        self.axis_names = tuple(self.axis_names)
        if tuple(self.shape) != self.axis_names:
            raise ValueError(f"mesh shape {self.shape} does not follow the "
                             f"axes {self.axis_names}")
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

        if self.device_mesh is not None and \
                tuple(self.device_mesh.mesh_dim_names) != self.axis_names:
            raise ValueError(f"device mesh axes "
                             f"{self.device_mesh.mesh_dim_names} are not "
                             f"{self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_device(self) -> torch.device:
        """The device this process computes on: its rank's slot on a
        process-group mesh, else the first slot."""
        if self.device_mesh is None:
            return self.devices[0]
        return self.devices[self.device_mesh.get_rank()]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement: the mesh and one entry per dim (a mesh axis,
    a tuple of mesh axes, or ``None`` for replicated)."""

    mesh: Mesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The DTensor placements of :attr:`spec` (:func:`placements`)."""
        return placements(self.spec, self.mesh)


_ctx = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Activate a mesh (+ optional rule overrides) for this thread's
    :func:`constrain` and ``engine.execute`` calls. It nests: leaving it
    restores the enclosing mesh, rules and implicit replication."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, {**RULES, **(rules or {})})
    dtensors = getattr(mesh, "device_mesh", None) is not None
    try:
        with _implicit_replication() if dtensors else contextlib.nullcontext():
            yield
    finally:
        _ctx.state = prev


@contextlib.contextmanager
def _implicit_replication():
    """``implicit_replication()`` that leaves the flag as it found it
    (torch's clears it on exit, ending an enclosing one)."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    try:
        with implicit_replication():
            yield
    finally:
        dispatcher._allow_implicit_replication = prev


def current_mesh() -> Optional[Mesh]:
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def current_rules() -> dict:
    """The rules :func:`use_mesh` made active on this thread (``RULES``
    and its overrides), else ``RULES``."""
    st = getattr(_ctx, "state", None)
    return st[1] if st else RULES


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


def placements(spec: Sequence, mesh) -> tuple:
    """A resolved spec (:func:`resolve_spec`) -> one DTensor placement per
    mesh axis: ``Shard(d)`` on every mesh axis that dim ``d`` names (a
    tuple such as ``("pod", "data")`` shards the dim over both, the first
    outermost, as a ``PartitionSpec`` orders them), ``Replicate()`` on the
    rest. A resolved spec never splits a dim unevenly, so neither do its
    placements.

    >>> m = Mesh((torch.device("cpu"),) * 4, ("data", "model"),
    ...          {"data": 2, "model": 2})
    >>> placements((("data",), None, "model"), m)
    (Shard(dim=0), Shard(dim=2))
    >>> placements((None, "model"), m)
    (Replicate(), Shard(dim=1))
    """
    out = [Replicate()] * len(mesh.axis_names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            out[mesh.axis_names.index(a)] = Shard(dim)
    return tuple(out)


def named_sharding(axes: Sequence[Optional[str]], shape: Sequence[int],
                   mesh: Optional[Mesh] = None) -> NamedSharding:
    """The resolved spec of ``axes`` on ``mesh`` (the active one by
    default); its ``placements`` are the DTensor placements."""
    mesh = mesh or current_mesh()
    return NamedSharding(mesh, resolve_spec(axes, shape, mesh))


def as_dtensor(t: torch.Tensor, device_mesh) -> DTensor:
    """``t`` as a DTensor on ``device_mesh``: itself if it is one, else
    replicated (every rank holds it whole: a position, a mask, an id)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def redistribute(x: DTensor, want: tuple) -> DTensor:
    """``x`` with placements ``want`` (``x`` itself when it has them)."""
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]):
    """The reference's ``with_sharding_constraint`` by logical axes.

    A DTensor is redistributed to the placements the active rules give
    its logical axes (a ``Partial`` sum becomes an all-reduce or a
    reduce-scatter, a replicated dim a local slice, a sharded one an
    all-gather). Without a mesh, on a mesh with no process group, and for
    a plain tensor on a process-group mesh (each rank holds all of it) it
    is the identity. A mesh with no process group cannot split a tensor:
    where its resolved placement would, ``constrain`` raises
    ``ValueError`` rather than compute unsplit."""
    st = getattr(_ctx, "state", None)
    if not st or st[0] is None:
        return x
    mesh, rules = st
    spec = resolve_spec(axes, x.shape, mesh, rules)
    if isinstance(x, DTensor):
        return redistribute(x, placements(spec, mesh))
    if getattr(mesh, "device_mesh", None) is None:
        split = [(dim, ax) for dim, ax in enumerate(spec)
                 if _mesh_axis_size(mesh, ax) > 1]
        if split:
            raise ValueError(
                f"the mesh {dict(mesh.shape)} would split a tensor of "
                f"shape {tuple(x.shape)} (logical axes {tuple(axes)}) over "
                f"dims {split}, but it has no process group: build it with "
                f"launch.mesh.make_mesh under torch.distributed")
    return x


def shard_offset(x: DTensor, dim: int) -> int:
    """Where this rank's shard of ``x`` starts along ``dim``: the mesh
    axes that split ``dim``, outermost first, index the equal blocks."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    block = 0
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            if type(p) is not Shard:
                raise ValueError(f"{p} is not an even block split")
            block = block * mesh.size(m) + coord[m]
    return block * (x.shape[dim] // _split_count(x, dim))


def write_block(dst: torch.Tensor, index: tuple, src: torch.Tensor):
    """``dst[index] = src`` for a block ``index`` of ints and step-1
    slices over ``dst``'s leading dims, returning ``dst``. A DTensor
    ``dst`` keeps its placements: ``src`` is whole on every rank (a
    DTensor ``src`` is gathered first: a block is one request's rows),
    and each rank writes the part of the block that falls in its own
    shard."""
    if not isinstance(dst, DTensor):
        dst[index] = src.to(dst.dtype)
        return dst
    if isinstance(src, DTensor):
        src = src.full_tensor()
    src = src.to(dst.dtype)
    local = dst.to_local()
    lidx, sidx = [], []
    for d in range(dst.ndim):
        o = shard_offset(dst, d)
        n = local.shape[d]
        ix = index[d] if d < len(index) else slice(None)
        if isinstance(ix, int):
            if not o <= ix < o + n:
                return dst                   # none of the block is ours
            lidx.append(ix - o)
            continue
        a, b, _ = ix.indices(dst.shape[d])
        lo, hi = max(a, o), min(b, o + n)
        if lo >= hi:
            return dst
        lidx.append(slice(lo - o, hi - o))
        sidx.append(slice(lo - a, hi - a))
    local[tuple(lidx)] = src[tuple(sidx)]
    return dst


def dtensor_zeros(shape, dtype, device_mesh, want: tuple,
                  device) -> DTensor:
    """A zero DTensor of global ``shape`` with placements ``want``, each
    rank allocating only its shard, on ``device`` (``meta`` allocates
    nothing)."""
    local = list(shape)
    for m, p in enumerate(want):
        if isinstance(p, Shard):
            local[p.dim] //= device_mesh.size(m)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), device_mesh, want,
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_strides(shape))


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, acc)
        acc *= n
    return tuple(stride)


def _split_count(x: DTensor, dim: int) -> int:
    n = 1
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(m)
    return n


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


def _rules(params: bool) -> dict:
    """``PARAM_RULES`` for parameters; for activations and caches the
    active rules (``use_mesh``'s overrides), as in the reference."""
    st = getattr(_ctx, "state", None)
    return PARAM_RULES if params else (st[1] if st else RULES)


def _axes_of(axes_tree, tree) -> list:
    """The logical-axes tuples of ``axes_tree``, one per tensor of
    ``tree``, in leaf order."""
    from ..models.spec import tree_leaves
    axes = tree_leaves(axes_tree, _is_axes)
    n = len(tree_leaves(tree))
    if len(axes) != n:
        raise ValueError(f"{len(axes)} axes for {n} tensors")
    return axes


def tree_shardings(axes_tree, abstract_tree, mesh: Optional[Mesh] = None,
                   params: bool = False):
    """Map a tree of logical-axes tuples and a tree of tensors of the same
    structure to a tree of :class:`NamedSharding`\\ s (each with its
    ``placements``).

    ``params=True`` applies ``PARAM_RULES`` (FSDP over 'data' on the embed
    dim); ``use_mesh`` rule overrides apply to activations and caches
    only, as in the reference.
    """
    from ..models.spec import tree_map
    mesh = mesh or current_mesh()
    rules = _rules(params)
    it = iter(_axes_of(axes_tree, abstract_tree))
    return tree_map(lambda arr: NamedSharding(
        mesh, resolve_spec(next(it), arr.shape, mesh, rules)),
        abstract_tree)


def distribute(t: torch.Tensor, want: tuple, mesh: Mesh) -> DTensor:
    """The DTensor over ``mesh`` with placements ``want`` whose global
    value is ``t``, which every rank holds whole (the same seed, the same
    file): each rank keeps its own shard and nothing is communicated. On
    ``meta`` the shards are shapes."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh.device_mesh, want, src_data_rank=None)


def distribute_tree(tree, axes_tree, mesh: Optional[Mesh] = None,
                    params: bool = False):
    """Place every tensor of ``tree`` on ``mesh`` by its logical axes:
    ``PARAM_RULES`` for parameters (``params=True``: tensor parallelism
    over 'model', FSDP of 'embed' over 'data'), the active rules for
    activations, caches and inputs. Each rank holds the whole tree and
    keeps its shards (:func:`distribute`). On a mesh with no process group
    the tree is returned as it is."""
    from ..models.spec import tree_map
    mesh = mesh or current_mesh()
    if getattr(mesh, "device_mesh", None) is None:
        return tree
    rules = _rules(params)
    it = iter(_axes_of(axes_tree, tree))
    return tree_map(lambda t: distribute(
        t, placements(resolve_spec(next(it), t.shape, mesh, rules), mesh),
        mesh), tree)


__all__ = ["Mesh", "NamedSharding", "PARAM_RULES", "RULES", "as_dtensor",
           "constrain", "contiguous_strides", "current_mesh", "current_rules",
           "distribute", "distribute_tree", "dtensor_zeros",
           "named_sharding", "placements", "redistribute", "resolve_spec",
           "shard_offset", "tree_shardings", "use_mesh", "write_block"]
