"""Tensors held in blocks over a :class:`~repro_torch.launch.mesh.DeviceMesh`:
the storage of a meshed LM step.

The reference lays its parameters, optimizer state and batch out on a
mesh with ``NamedSharding``s and lets GSPMD place every shard and emit the
collectives.  The port places them itself, in one process:

* a :class:`BlockStore` holds each tensor of a tree (parameters keyed by
  their ``named_parameters()`` names, or their moments, masters, residual)
  as blocks, one per grid position: the block at the position's
  coordinates along the mesh axes its spec names, a copy where the spec
  leaves an axis replicated.  A dim sharded over several axes is split
  with the first axis major, as the reference splits it;
* a :class:`BlockView` reads the store as the model code reads a
  ``ParamTree`` (``p["attn"]["wq"]``): each leaf it is asked for is
  gathered from its blocks onto one device, by ``.to`` and ``torch.cat``,
  both differentiable, so the gradient of what a shard computed comes
  back to the blocks it read.  A view gathers on every access and keeps
  nothing, so a gather made inside a remat region is made again by the
  recompute;
* :func:`batch_shards` splits a batch as the reference's
  ``sharding_for(shape, ("batch", ...))`` splits it: over the mesh axes
  that ``batch`` maps to, each shard on the position at its coordinates
  and index 0 of every other axis; a batch that does not divide is held
  whole by the first position (the axis is dropped).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.partition import Spec, axes_of, sharding_for

__all__ = [
    "BlockStore",
    "BlockView",
    "Shard",
    "batch_shards",
    "join_rows",
    "shard_params",
    "shard_views",
    "split_rows",
]

Pos = Tuple[int, ...]


def _coords(mesh, pos: Pos) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, pos))


def _device(mesh, pos: Pos) -> torch.device:
    return mesh.device_at(**_coords(mesh, pos))


def _digits(mesh, axes: Sequence[str], i: int) -> Dict[str, int]:
    """Index ``i`` of a split over ``axes`` as each axis's coordinate (the
    first axis major)."""
    out = {}
    for a in reversed(axes):
        i, out[a] = divmod(i, mesh.shape[a])
    return out


def _block_index(mesh, spec: Spec, pos: Pos) -> Tuple[int, ...]:
    """Per dim, the index of the block ``pos`` holds."""
    coord = _coords(mesh, pos)
    out = []
    for entry in spec:
        idx = 0
        for a in axes_of(entry):
            idx = idx * mesh.shape[a] + coord[a]
        out.append(idx)
    return tuple(out)


def _block_slices(mesh, spec: Spec, shape, index) -> Tuple[slice, ...]:
    out = []
    for entry, dim, i in zip(spec, shape, index):
        n = dim // math.prod(mesh.shape[a] for a in axes_of(entry))
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


class BlockStore:
    """Named tensors held as blocks on every position of ``mesh``.

    ``blocks[name][pos]`` is the block at grid position ``pos`` (a tuple of
    coordinates in ``mesh.axis_names`` order) on that position's device.
    ``tree`` mirrors the parameter tree (dicts, lists for runs of layers,
    leaves the names), for :class:`BlockView`.  Names keep the order they
    were given in (``named_parameters()`` order)."""

    def __init__(self, mesh, specs: Mapping[str, Spec], shapes: Mapping[str, torch.Size],
                 blocks: Mapping[str, Dict[Pos, torch.Tensor]], tree=None):
        self.mesh = mesh
        self.specs = dict(specs)
        self.shapes = {n: torch.Size(s) for n, s in shapes.items()}
        self.blocks = dict(blocks)
        self.tree = tree
        self.positions: List[Pos] = list(itertools.product(
            *(range(n) for n in mesh.shape.values())))

    @classmethod
    @torch.no_grad()
    def from_tensors(cls, named: Mapping[str, torch.Tensor], specs: Mapping[str, Spec], mesh,
                     *, dtype=None, tree=None) -> "BlockStore":
        """Each tensor cut into its blocks and copied to every position (in
        ``dtype`` when given)."""
        store = cls(mesh, {n: specs[n] for n in named},
                    {n: t.shape for n, t in named.items()}, {}, tree)
        for name, t in named.items():
            store.blocks[name] = {}
            for pos in store.positions:
                sl = store.slices(name, pos)
                block = torch.empty(t[sl].shape, dtype=dtype or t.dtype,
                                    device=_device(mesh, pos))
                store.blocks[name][pos] = block.copy_(t[sl])
        return store

    def like(self, make) -> "BlockStore":
        """A store of the same layout whose blocks are ``make(block)``."""
        return BlockStore(self.mesh, self.specs, self.shapes,
                          {n: {pos: make(b) for pos, b in bl.items()}
                           for n, bl in self.blocks.items()}, self.tree)

    @property
    def names(self) -> List[str]:
        return list(self.blocks)

    @property
    def home_device(self) -> torch.device:
        """The first position's device."""
        return _device(self.mesh, self.positions[0])

    def index(self, name: str, pos: Pos) -> Tuple[int, ...]:
        """The index of the block ``pos`` holds of ``name``."""
        return _block_index(self.mesh, self.specs[name], pos)

    def slices(self, name: str, pos: Pos) -> Tuple[slice, ...]:
        """Where the block ``pos`` holds lies in the whole tensor."""
        spec, shape = self.specs[name], self.shapes[name]
        return _block_slices(self.mesh, spec, shape, _block_index(self.mesh, spec, pos))

    def holders(self, name: str) -> Dict[Tuple[int, ...], Pos]:
        """Each block index of ``name`` -> the first position (row-major)
        that holds it."""
        out: Dict[Tuple[int, ...], Pos] = {}
        for pos in self.positions:
            out.setdefault(self.index(name, pos), pos)
        return out

    def gather(self, name: str, at: Pos, device, blocks=None) -> torch.Tensor:
        """The whole tensor ``name`` on ``device``, joined from the blocks
        the position ``at`` reads: its own where the spec replicates an
        axis, every block along the axes it shards.  Differentiable; a
        leaf held whole is returned as its block (moved when ``device``
        differs).  ``blocks`` stands in for this store's own (a shard's
        aliases)."""
        blocks = (self.blocks if blocks is None else blocks)[name]
        spec = self.specs[name]
        base = _coords(self.mesh, at)

        def build(dim: int, coord: Dict[str, int]) -> torch.Tensor:
            if dim == len(spec):
                return blocks[tuple(coord[a] for a in self.mesh.axis_names)].to(device)
            axes = axes_of(spec[dim])
            n = math.prod(self.mesh.shape[a] for a in axes)
            parts = [build(dim + 1, {**coord, **_digits(self.mesh, axes, i)}) for i in range(n)]
            return parts[0] if n == 1 else torch.cat(parts, dim)

        return build(0, base)

    def full(self, name: str, device=None) -> torch.Tensor:
        """``name`` whole on ``device`` (the first position's by default)."""
        return self.gather(name, self.positions[0], device or self.home_device)

    def view(self, at: Optional[Pos] = None, device=None, blocks=None) -> "BlockView":
        """The parameter tree as position ``at`` reads it, gathered onto
        ``device`` (the first position and its device by default)."""
        at = self.positions[0] if at is None else at
        return BlockView(self, self.tree, at, device or _device(self.mesh, at), blocks)

    def __getitem__(self, key):
        """The tree as the first position reads it (``store["embed"]``)."""
        return self.view()[key]

    def __contains__(self, key) -> bool:
        return key in self.tree

    def aliases(self) -> Dict[str, Dict[Pos, torch.Tensor]]:
        """Every block detached, sharing its storage, with gradients on:
        the leaves one shard's autograd graph is rooted at."""
        return {n: {pos: b.detach().requires_grad_(True) for pos, b in bl.items()}
                for n, bl in self.blocks.items()}

    def nbytes_at(self, pos: Pos) -> int:
        """Bytes the position ``pos`` holds."""
        return sum(bl[pos].numel() * bl[pos].element_size() for bl in self.blocks.values())


class BlockView:
    """A node of a :class:`BlockStore`'s parameter tree as one position reads
    it: ``view["key"]`` or ``view[i]`` is a child view or, at a leaf, the
    leaf gathered onto ``device``.  Runs of layers iterate and have a
    length, as the ``ModuleList`` s of a ``ParamTree`` do."""

    def __init__(self, store: BlockStore, node, at: Pos, device, blocks=None):
        self._store, self._node, self._at, self._device = store, node, at, device
        self._blocks = blocks

    def __getitem__(self, key):
        node = self._node[key]
        if isinstance(node, str):
            return self._store.gather(node, self._at, self._device, self._blocks)
        return BlockView(self._store, node, self._at, self._device, self._blocks)

    def __contains__(self, key) -> bool:
        return key in self._node

    def __len__(self) -> int:
        return len(self._node)

    def __iter__(self) -> Iterator:
        return (self[i] for i in range(len(self._node)))


def _name_tree(module: torch.nn.Module, prefix: str = ""):
    """A ``ParamTree``'s structure with each leaf replaced by its name."""
    if isinstance(module, torch.nn.ModuleList):
        return [_name_tree(m, f"{prefix}{i}.") for i, m in enumerate(module)]
    out = {n: prefix + n for n in module._parameters}
    out.update({n: _name_tree(m, f"{prefix}{n}.") for n, m in module._modules.items()})
    return out


def shard_params(params, cfg, mesh) -> BlockStore:
    """``params`` laid out on ``mesh``: a :class:`BlockStore` as it is; a
    model (``ParamTree``) cut into blocks by its specs (``pspec_tree``,
    ``launch.specs.param_shardings``) and copied."""
    if isinstance(params, BlockStore):
        if params.mesh != mesh:
            raise ValueError("the parameters are laid out on another mesh")
        return params
    from repro_torch.launch.specs import param_shardings

    specs = {n: s.spec for n, s in param_shardings(cfg, mesh).items()}
    named = {n: p.detach() for n, p in params.named_parameters()}
    return BlockStore.from_tensors(named, specs, mesh, tree=_name_tree(params))


def shard_views(params, cfg, mesh, batch: int):
    """(one :class:`BlockView` per batch shard, reading ``params`` laid out
    on ``mesh`` onto the shard's device; the :func:`batch_shards` of a
    batch of ``batch`` rows)."""
    store = shard_params(params, cfg, mesh)
    shards = batch_shards(mesh, batch)
    return [store.view(s.pos, s.device) for s in shards], shards


@dataclasses.dataclass(frozen=True)
class Shard:
    """One batch shard: its grid position, its device, its rows."""

    pos: Pos
    device: torch.device
    rows: slice


def batch_shards(mesh, batch: int) -> List[Shard]:
    """The shards of a batch of ``batch`` rows, in order (first batch axis
    major), by ``sharding_for((batch,), ("batch",), mesh)``."""
    axes = axes_of(sharding_for((batch,), ("batch",), mesh).spec[0])
    n = math.prod(mesh.shape[a] for a in axes)
    rows = batch // n
    out = []
    for i in range(n):
        coord = _digits(mesh, axes, i)
        pos = tuple(coord.get(a, 0) for a in mesh.axis_names)
        out.append(Shard(pos, _device(mesh, pos), slice(i * rows, (i + 1) * rows)))
    return out


def split_rows(x: torch.Tensor, shards: Sequence[Shard], dim: int = 0) -> List[torch.Tensor]:
    """Each shard's rows of ``x`` (along ``dim``), on its device."""
    return [x[(slice(None),) * dim + (s.rows,)].to(s.device) for s in shards]


def join_rows(xs: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards' rows joined on ``device``."""
    parts = [x.to(device) for x in xs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
