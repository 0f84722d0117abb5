"""Declarative parameters: the port's copy of ``repro/models/base.py``.

Modules describe their parameters as a nested dict of :class:`ParamDecl`
(shape, dtype, init, logical sharding axes), the reference's declarations
field for field.  A list in the tree is a run of layers.  The walkers
turn a declaration tree into

  * a :class:`ParamTree`, an ``nn.Module`` whose children and
    ``nn.Parameter``s carry the declarations' names, shapes and dtypes,
    drawn by :func:`init_params` from a ``jax.random`` key as the
    reference draws them, or left on the meta device by
    :func:`abstract_params` (the counterpart of ``ShapeDtypeStruct``);
  * the spec of each parameter on a mesh (:func:`pspec_tree`);
  * counts of parameters and bytes (:func:`param_count`,
    :func:`param_bytes`).

Apply functions are plain functions ``f(p, x, cfg, ...)``
that index a tree as the reference indexes its dicts: ``p["wq"]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.sharding.partition import axes_of
from repro_torch.sharding.partition import spec as logical_spec

__all__ = [
    "ParamDecl",
    "ParamTree",
    "abstract_params",
    "init_params",
    "param_bytes",
    "param_count",
    "pspec_tree",
]


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """One parameter: shape, dtype, init scheme, logical sharding axes."""

    shape: Tuple[int, ...]
    axes: Tuple[Any, ...]                 # logical axes, len == ndim
    dtype: Any = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: Optional[float] = None         # stddev override
    #: Where the reference draws a layer's parameter: its leaf's key path
    #: in the reference's tree and the layer's index along that leaf's
    #: stacked leading axis (None: not stacked).  Unset, the parameter is
    #: drawn at its own path.
    drawn_at: Optional[Tuple[Tuple[str, ...], Optional[int]]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


class ParamTree(nn.Module):
    """A module built from a declaration dict: each sub-dict is a child
    :class:`ParamTree`, each list an ``nn.ModuleList``, each
    :class:`ParamDecl` an ``nn.Parameter`` of its shape and dtype.
    Parameters are made without gradients (serving needs none; a trainer
    turns them on with ``requires_grad_()``).  ``tree["name"]`` reads a
    child or parameter, as the reference reads its dicts."""

    def __init__(self, decls: Dict, device=None):
        super().__init__()
        for name, d in decls.items():
            if isinstance(d, ParamDecl):
                t = torch.empty(d.shape, dtype=d.dtype, device=device)
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))
            elif isinstance(d, list):
                self.add_module(name, nn.ModuleList(ParamTree(x, device) for x in d))
            else:
                self.add_module(name, ParamTree(d, device))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _leaves(decls, path=()):
    """``(path, decl)`` in the reference's draw order: dict keys sorted,
    list items in order."""
    if isinstance(decls, ParamDecl):
        yield path, decls
    elif isinstance(decls, list):
        for i, d in enumerate(decls):
            yield from _leaves(d, path + (i,))
    else:
        for k in sorted(decls):
            yield from _leaves(decls[k], path + (k,))


def _param_at(tree: nn.Module, path) -> nn.Parameter:
    node = tree
    for k in path:
        node = node[k]
    return node


@torch.no_grad()
def _init_one(t: torch.Tensor, decl: ParamDecl, key: torch.Tensor, start: int) -> None:
    if decl.init == "zeros":
        t.zero_()
        return
    if decl.init == "ones":
        t.fill_(1)
        return
    fan_in = decl.shape[0] if decl.shape else 1
    if decl.init == "embed":
        std = decl.scale if decl.scale is not None else 1.0
    else:
        std = decl.scale if decl.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    draw = prng.normal(key, decl.shape, start=start)
    t.copy_(draw.mul_(float(np.float32(std))).to(decl.dtype))


def init_params(decls: Dict, key: torch.Tensor, device=None) -> ParamTree:
    """A :class:`ParamTree` on ``device`` (the key's by default; the draws
    are made on the key's device and copied) drawn as the reference's
    ``init_params`` draws its tree from ``key``: ``split(key, n_leaves)``
    over the reference's leaves in sorted path order, then
    ``normal(k, shape) * std`` cast to the leaf's dtype, std
    ``1/sqrt(fan_in)`` (``fan_in`` the first dim), ``embed`` 1.0, ``scale``
    where given; zeros and ones take their key too.  A layer the reference
    stacks (``ParamDecl.drawn_at``) draws its slice of the stacked leaf's
    normal: the elements from ``index * size`` of its flat order, with the
    stack's std (``transformer._cycle_decls``)."""
    device = key.device if device is None else torch.device(device)
    tree = ParamTree(decls, device)
    groups: Dict[Tuple[str, ...], list] = {}
    for path, d in _leaves(decls):
        at, index = d.drawn_at or (tuple(map(str, path)), None)
        groups.setdefault(at, []).append((index or 0, path, d))
    keys = prng.split(key, max(len(groups), 1))
    for k, at in zip(keys, sorted(groups)):
        for index, path, d in groups[at]:
            _init_one(_param_at(tree, path), d, k, index * math.prod(d.shape))
    return tree


def drawn_as_stack(tree, at: Tuple[str, ...], index: Optional[int]):
    """``tree`` (a layer's declarations) marked as drawn at the reference's
    path ``at`` (each parameter under its own sub-path) and ``index`` along
    the stacked leading axis (None: a layer the reference keeps alone)."""
    if isinstance(tree, ParamDecl):
        return dataclasses.replace(tree, drawn_at=(at, index))
    return {k: drawn_as_stack(v, at + (k,), index) for k, v in tree.items()}


def abstract_params(decls: Dict) -> ParamTree:
    """The tree on the meta device: shapes and dtypes, no memory."""
    return ParamTree(decls, "meta")


def _map_decls(fn, tree):
    if isinstance(tree, ParamDecl):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_decls(fn, d) for d in tree]
    return {k: _map_decls(fn, v) for k, v in tree.items()}


def pspec_tree(decls: Dict, mesh) -> Dict:
    """The spec of each parameter on ``mesh`` (the tree of ``decls``).

    A layer's spec is the reference's stacked spec without its leading
    ``None``.  Dims whose size does not divide over the product of their
    mesh axes are left unsharded (e.g. seamless's 256,206 vocab on a
    16-way tensor axis), as in the reference."""
    def one(d: ParamDecl):
        fixed = []
        for dim, axes in zip(d.shape, logical_spec(d.axes, mesh)):
            ways = math.prod(mesh.shape[a] for a in axes_of(axes))
            fixed.append(axes if dim % ways == 0 else None)
        return tuple(fixed)

    return _map_decls(one, decls)


def param_count(decls: Dict) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(decls))


def param_bytes(decls: Dict) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for _, d in _leaves(decls))
