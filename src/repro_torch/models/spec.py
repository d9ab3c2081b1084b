"""Parameter specs: shape + logical axes + initializer, built once per model.

The port of ``src/repro/models/spec.py``. A model builder returns a tree
(nested dicts) of :class:`Spec`; from it we derive

  * concrete params        (:func:`init_params`, on a ``torch.Generator``)
  * abstract params        (:func:`abstract_params`, tensors on ``meta``)
  * logical-axis tree      (:func:`axes_tree`, for ``distributed.sharding``)

:func:`init_params` draws from a seeded ``torch.Generator``, which cannot
reproduce ``jax.random``; :func:`params_from_numpy` carries the
reference's own parameters (its ``init_params`` tree as numpy arrays)
across, which is how every comparison with the reference runs.

Trees are nested dicts, lists, tuples and ``NamedTuple``s whose leaves
are specs or tensors; leaves are visited in the reference's pytree order
(``jax.tree.flatten``'s: dict keys sorted, ``NamedTuple`` fields in
declaration order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis per dim
    init: str = "normal"              # normal | zeros | ones
    scale: Optional[float] = None     # default: 1/sqrt(fan_in)
    dtype: Optional[str] = None       # None -> model dtype (cfg.dtype)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _is_tensor(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def tree_map(fn: Callable, tree, is_leaf: Callable = _is_tensor):
    """Apply ``fn`` to every leaf of a tree of dicts, lists, tuples and
    ``NamedTuple``s, keeping its structure; ``is_leaf`` says what a leaf
    is (tensors and numpy arrays by default). Leaves are visited dict keys
    sorted, ``NamedTuple`` fields in declaration order.

    >>> t = {"b": torch.zeros(2), "a": (torch.zeros(1, 3),)}
    >>> tree_map(lambda a: tuple(a.shape), t)
    {'b': (2,), 'a': ((1, 3),)}
    """
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t, is_leaf) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def tree_leaves(tree, is_leaf: Callable = _is_tensor) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_unflatten(like, leaves, is_leaf: Callable = _is_tensor):
    """A tree of ``like``'s structure holding ``leaves``, taken in
    :func:`tree_leaves`' order."""
    leaves = list(leaves)
    n = len(tree_leaves(like, is_leaf))
    if n != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), like, is_leaf)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``, …) or a torch
    dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def wide(dtype) -> torch.dtype:
    """The dtype the layers compute norms, rotary angles, attention
    logits and softmax, the SSM scan and the logits in: float32, as the
    reference does for its bfloat16 and float32 models, and float64 for a
    float64 model (a precision reference for the float32 runs)."""
    return (torch.float64 if torch_dtype(dtype) == torch.float64
            else torch.float32)


def init_params(specs, generator: torch.Generator,
                default_dtype="bfloat16", device=None):
    """Concrete parameters for a spec tree, drawn from ``generator``.

    Normal leaves are ``N(0, 1) · scale`` (``scale`` defaults to
    ``1/sqrt(fan_in)``, the first dim), drawn in float32 on the
    generator's device, in leaf order, then cast to the leaf's dtype
    (``Spec.dtype``, else ``default_dtype``) and moved to ``device``
    (default: the generator's device).
    """
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def make(spec: Spec):
        dtype = torch_dtype(spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = spec.shape[0] if spec.shape else 1
        scale = (spec.scale if spec.scale is not None
                 else 1.0 / math.sqrt(max(fan_in, 1)))
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=gdev)
        return (w * scale).to(dtype=dtype, device=device)

    return tree_map(make, specs, is_spec)


def params_from_numpy(tree, dtype=None, device="cuda"):
    """The reference's parameters (a tree of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, init_params(...))``) as the port's: the same
    tree of torch tensors on ``device`` (the card unless ``device="cpu"``
    is asked for; raises without CUDA), each in its own dtype (bfloat16
    arrays, which numpy holds as ``ml_dtypes.bfloat16``, arrive as
    ``torch.bfloat16``), or all cast to ``dtype`` when given."""
    device = resolve_device(device)

    def conv(a):
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(a.view(np.uint16),
                                          order="C")).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, order="C"))
        t = t.to(device)
        return t if dtype is None else t.to(torch_dtype(dtype))

    return tree_map(conv, tree, lambda x: isinstance(x, np.ndarray))


def abstract_params(specs, default_dtype="bfloat16"):
    """Shape-and-dtype stand-ins for the parameters: tensors on the
    ``meta`` device, which allocate nothing."""
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(
            s.dtype or default_dtype), device="meta"), specs, is_spec)


def axes_tree(specs):
    return tree_map(lambda s: s.axes, specs, is_spec)


def stack_specs(spec_tree, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacking dimension (the group axis the layer loop walks)."""
    return tree_map(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                       s.scale, s.dtype),
        spec_tree, is_spec)


def param_count(params) -> int:
    """Elements over every leaf of a parameter tree."""
    return sum(t.numel() for t in tree_leaves(params))


def param_bytes(params) -> int:
    """Bytes over every leaf of a parameter tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


__all__ = ["Spec", "abstract_params", "axes_tree", "init_params",
           "is_spec", "param_bytes", "param_count", "params_from_numpy",
           "stack_specs", "torch_dtype", "tree_leaves", "tree_map",
           "tree_unflatten"]
