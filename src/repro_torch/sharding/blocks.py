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
  ``ParamTree`` (``p["attn"]["wq"]``) at one grid position: each leaf it
  is asked for is gathered from its blocks onto the position's device, by
  ``.to`` and ``torch.cat``, both differentiable, so the gradient of what
  a shard computed comes back to the blocks it read.  A view gathers on
  every access and keeps nothing, so a gather made inside a remat region
  is made again by the recompute;
* tensor and expert parallelism: a leaf's ``tensor`` and ``expert`` dims
  (its declaration's logical axes) are *model dims*.  ``view.local(key)``
  gathers a leaf over the axes of its other dims only and returns the
  position's own block along the model dims; :func:`model_group` gives
  the views of every position of a data shard along ``model``, which a
  split layer runs on, one block each.  ``view[key]`` returns a leaf whole;
  where that gathers a model dim across ``model`` (a layer that cannot
  split the leaf into whole heads, units, vocab entries or experts) the
  store records the leaf and the reason (:attr:`BlockStore.gathered`);
* :func:`batch_shards` splits a batch as the reference's
  ``sharding_for(shape, ("batch", ...))`` splits it: over the mesh axes
  that ``batch`` maps to, each shard on the position at its coordinates
  and index 0 of every other axis; a batch that does not divide is held
  whole by the first position (the axis is dropped).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.partition import Spec, axes_of, sharding_for

__all__ = [
    "BlockStore",
    "BlockView",
    "ModelBlocks",
    "ModelGroup",
    "Shard",
    "batch_shards",
    "join_rows",
    "lay_out_cache",
    "model_group",
    "shard_params",
    "shard_views",
    "split_rows",
    "state_blocks",
    "state_like",
    "whole_group",
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


def _along_model(mesh, pos: Pos, m: int) -> Pos:
    """``pos`` with its ``model`` coordinate set to ``m``."""
    return tuple(m if a == "model" else c for a, c in zip(mesh.axis_names, pos))


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
    were given in (``named_parameters()`` order).  ``logical[name]`` is a
    leaf's declared logical axes, which name its model dims (none where it
    is not given).  ``gathered`` maps each leaf a view had to gather across
    ``model`` to the reason; ``local_reads`` counts, per position, the
    leaves a split layer read as that position's own blocks."""

    def __init__(self, mesh, specs: Mapping[str, Spec], shapes: Mapping[str, torch.Size],
                 blocks: Mapping[str, Dict[Pos, torch.Tensor]], tree=None, logical=None):
        self.mesh = mesh
        self.specs = dict(specs)
        self.shapes = {n: torch.Size(s) for n, s in shapes.items()}
        self.blocks = dict(blocks)
        self.tree = tree
        self.logical = dict(logical or {})
        self.gathered: Dict[str, str] = {}
        self.local_reads: collections.Counter = collections.Counter()
        self.positions: List[Pos] = list(itertools.product(
            *(range(n) for n in mesh.shape.values())))

    @classmethod
    @torch.no_grad()
    def from_tensors(cls, named: Mapping[str, torch.Tensor], specs: Mapping[str, Spec], mesh,
                     *, dtype=None, tree=None, logical=None) -> "BlockStore":
        """Each tensor cut into its blocks and copied to every position (in
        ``dtype`` when given)."""
        store = cls(mesh, {n: specs[n] for n in named},
                    {n: t.shape for n, t in named.items()}, {}, tree, logical)
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
                           for n, bl in self.blocks.items()}, self.tree, self.logical)

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

    def model_dims(self, name: str) -> Tuple[int, ...]:
        """The dims of ``name`` declared ``tensor`` or ``expert`` that its
        spec splits over some mesh axis."""
        logical, spec = self.logical.get(name, ()), self.specs[name]
        return tuple(i for i, a in enumerate(logical)
                     if a in _MODEL_AXES and axes_of(spec[i]))

    def gather(self, name: str, at: Pos, device, blocks=None, local: bool = False
               ) -> torch.Tensor:
        """The whole tensor ``name`` on ``device``, joined from the blocks
        the position ``at`` reads: its own where the spec replicates an
        axis, every block along the axes it shards; with ``local``, its own
        block along the model dims (:meth:`model_dims`).  Differentiable; a
        leaf held whole is returned as its block (moved when ``device``
        differs).  ``blocks`` stands in for this store's own (a shard's
        aliases)."""
        blocks = (self.blocks if blocks is None else blocks)[name]
        spec = self.specs[name]
        base = _coords(self.mesh, at)
        keep = self.model_dims(name) if local else ()

        def build(dim: int, coord: Dict[str, int]) -> torch.Tensor:
            if dim == len(spec):
                return blocks[tuple(coord[a] for a in self.mesh.axis_names)].to(device)
            axes = () if dim in keep else axes_of(spec[dim])
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
    leaf gathered whole onto ``device``; :meth:`local` is the position's
    own block of a leaf.  Runs of layers iterate and have a length, as the
    ``ModuleList`` s of a ``ParamTree`` do."""

    def __init__(self, store: BlockStore, node, at: Pos, device, blocks=None):
        self._store, self._node, self._at, self._device = store, node, at, device
        self._blocks = blocks

    @property
    def device(self) -> torch.device:
        return self._device

    def __getitem__(self, key):
        node = self._node[key]
        if isinstance(node, str):
            return self.whole(key, "read whole by a layer that does not split it")
        return BlockView(self._store, node, self._at, self._device, self._blocks)

    def model_dims(self, key) -> Tuple[int, ...]:
        """The leaf ``key``'s model dims split over the mesh."""
        return self._store.model_dims(self._node[key])

    def is_split(self, key) -> bool:
        """Whether the leaf ``key`` has a model dim split over the mesh."""
        return bool(self.model_dims(key))

    def local(self, key) -> torch.Tensor:
        """The leaf ``key`` gathered over the axes of its other dims, with
        this position's own block along its model dims."""
        self._store.local_reads[self._at] += 1
        return self._store.gather(self._node[key], self._at, self._device, self._blocks,
                                  local=True)

    def whole(self, key, reason: str) -> torch.Tensor:
        """The leaf ``key`` gathered whole; a leaf whose model dims are
        split is recorded in the store's ``gathered`` with ``reason``."""
        name = self._node[key]
        if self._store.model_dims(name):
            self._store.gathered.setdefault(name, reason)
        return self._store.gather(name, self._at, self._device, self._blocks)

    def note_gathered(self, key, reason: str) -> None:
        """Record ``reason`` for the leaf ``key`` if its model dims are split
        (a layer about to read it whole)."""
        name = self._node[key]
        if self._store.model_dims(name):
            self._store.gathered.setdefault(name, reason)

    def at_model(self, m: int) -> "BlockView":
        """This node as the position ``m`` along ``model`` of this view's
        data shard reads it."""
        at = _along_model(self._store.mesh, self._at, m)
        return BlockView(self._store, self._node, at, _device(self._store.mesh, at),
                         self._blocks)

    def __contains__(self, key) -> bool:
        return key in self._node

    def __len__(self) -> int:
        return len(self._node)

    def __iter__(self) -> Iterator:
        return (self[i] for i in range(len(self._node)))


#: Logical axes whose dims a tensor- or expert-parallel layer splits.
_MODEL_AXES = ("tensor", "expert")


class _Whole:
    """A node read whole by the one position of a group that does not split
    it: a parameter tree, or a :class:`BlockView` whose leaves are gathered
    whole (and recorded where split).  ``device`` is the view's, None for a
    parameter tree (its leaves', where the layer's input is)."""

    def __init__(self, p):
        self._p = p
        self.device = p.device if isinstance(p, BlockView) else None

    def local(self, key) -> torch.Tensor:
        return self._p[key]

    def whole(self, key, reason: str) -> torch.Tensor:
        return self._p[key]


@dataclasses.dataclass
class ModelGroup:
    """The positions of one data shard along ``model``, each with its view of
    one node: a split layer runs position ``m`` on ``views[m]``, on its
    device, and combines the results with the model-axis operators of
    ``distributed/collectives.py``, which are the identity at one
    position."""

    views: List

    @property
    def size(self) -> int:
        return len(self.views)

    @property
    def devices(self) -> List[torch.device]:
        return [v.device for v in self.views]

    def local(self, key) -> List[torch.Tensor]:
        """Each position's own block of the leaf ``key``."""
        return [v.local(key) for v in self.views]

    def whole(self, key, reason: str) -> List[torch.Tensor]:
        """The leaf ``key`` whole on each position (recorded when split)."""
        return [v.whole(key, reason) for v in self.views]


def whole_group(p) -> ModelGroup:
    """The group of one position that reads ``p``'s leaves whole."""
    return ModelGroup([_Whole(p)])


def model_group(p, *split: str) -> ModelGroup:
    """The :class:`ModelGroup` of ``p``'s data shard, each position reading
    its own blocks, when ``p`` is a :class:`BlockView` on a mesh with more
    than one position along ``model`` and each leaf named in ``split`` has
    a model dim split over the mesh; else :func:`whole_group` (the layer
    runs whole, as unmeshed)."""
    if isinstance(p, BlockView):
        n = p._store.mesh.shape.get("model", 1)
        if n > 1 and all(p.is_split(k) for k in split):
            return ModelGroup([p.at_model(m) for m in range(n)])
    return whole_group(p)


@dataclasses.dataclass
class ModelBlocks:
    """One leaf of a data shard's decode cache as its positions along
    ``model`` hold it: ``blocks[m]`` on position ``m``'s device, split along
    ``dim`` (None: each position holds the leaf whole)."""

    blocks: List[torch.Tensor]
    dim: Optional[int] = None

    def whole(self, device) -> torch.Tensor:
        """The leaf joined on ``device``."""
        if self.dim is None:
            return self.blocks[0].to(device)
        return torch.cat([b.to(device) for b in self.blocks], self.dim)

    def like(self, t: torch.Tensor) -> "ModelBlocks":
        """``t`` (the whole leaf) laid out as this one."""
        if self.dim is None:
            return ModelBlocks([t.to(b.device) for b in self.blocks], None)
        parts = t.chunk(len(self.blocks), self.dim)
        return ModelBlocks([x.to(b.device) for x, b in zip(parts, self.blocks)], self.dim)


def state_blocks(t, n: int, device) -> List[torch.Tensor]:
    """A decode-state leaf ``t`` as the ``n`` positions of a group read it:
    its blocks where it is :class:`ModelBlocks` of ``n`` blocks; else one
    block, the leaf whole (on ``device`` when it is held in blocks)."""
    if isinstance(t, ModelBlocks):
        return t.blocks if len(t.blocks) == n else [t.whole(device)]
    return [t]


def state_like(t, blocks: Sequence[torch.Tensor], dim: Optional[int]):
    """New blocks of the state leaf ``t`` (as :func:`state_blocks` read it)
    laid out as ``t`` is: a tensor, :class:`ModelBlocks` of ``blocks``
    split along ``dim``, or the one whole block in ``t``'s layout."""
    if not isinstance(t, ModelBlocks):
        return blocks[0]
    if len(blocks) == len(t.blocks):
        return ModelBlocks(list(blocks), dim)
    return t.like(blocks[0])


def lay_out_cache(cache: Sequence[Dict[str, torch.Tensor]], kinds: Sequence[str], mesh
                  ) -> BlockStore:
    """A per-layer decode cache (layer ``i`` of kind ``kinds[i]``) laid out on
    ``mesh`` as ``launch.specs.cache_shardings`` lays it out: attention
    ``k``/``v`` split by ``seq``, the recurrent states by ``tensor``, the
    mLSTM state replicated, the batch over the data axes.  Leaf ``leaf`` of
    layer ``i`` is named ``"{i}.{leaf}"``."""
    from repro_torch.launch.specs import cache_leaf_axes

    named, specs, logical, tree = {}, {}, {}, []
    for i, (layer, kind) in enumerate(zip(cache, kinds)):
        node = {}
        for leaf, t in layer.items():
            name = node[leaf] = f"{i}.{leaf}"
            named[name], logical[name] = t, cache_leaf_axes(kind, leaf)
            specs[name] = sharding_for(tuple(t.shape), logical[name], mesh).spec
        tree.append(node)
    return BlockStore.from_tensors(named, specs, mesh, tree=tree, logical=logical)


def shard_cache(store: BlockStore, at: Pos) -> List[Dict[str, ModelBlocks]]:
    """The layers of a laid-out cache as the data shard at ``at`` (its
    position at index 0 of ``model``) holds them."""
    pos = [_along_model(store.mesh, at, m) for m in range(store.mesh.shape.get("model", 1))]

    def one(name):
        spec = store.specs[name]
        dim = next((i for i, e in enumerate(spec) if "model" in axes_of(e)), None)
        return ModelBlocks([store.blocks[name][p] for p in pos], dim)

    return [{leaf: one(name) for leaf, name in layer.items()} for layer in store.tree]


def store_shard_cache(store: BlockStore, at: Pos, layers: Sequence[Dict[str, ModelBlocks]]
                      ) -> None:
    """Write a data shard's new cache blocks back into ``store``."""
    for node, layer in zip(store.tree, layers):
        for leaf, mb in layer.items():
            for m, b in enumerate(mb.blocks):
                store.blocks[node[leaf]][_along_model(store.mesh, at, m)] = b


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
    from repro_torch.launch.specs import param_logical_axes, param_shardings

    specs = {n: s.spec for n, s in param_shardings(cfg, mesh).items()}
    named = {n: p.detach() for n, p in params.named_parameters()}
    return BlockStore.from_tensors(named, specs, mesh, tree=_name_tree(params),
                                   logical=param_logical_axes(cfg))


def shard_views(params, cfg, mesh, batch: int):
    """(one :class:`BlockView` per batch shard, reading ``params`` laid out
    on ``mesh`` onto the shard's device; the :func:`batch_shards` of a
    batch of ``batch`` rows).  Each view is the shard's position at index 0
    of ``model``; a split layer reaches every position of the shard from it
    (:func:`model_group`)."""
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
