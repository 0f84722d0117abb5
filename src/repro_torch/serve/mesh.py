"""Serving across a device mesh (counterpart of ``repro/serve/mesh.py``).

The chip sustains 60.3k classifications/s because 128 clauses evaluate in
parallel every cycle; the flexible-substrate follow-up (Qin et al.)
replicates the same TM datapath across independent tiles.  The software
counterpart is a :class:`ServeMesh`: each registered
:class:`~repro_torch.serve.servable.ServableModel` is placed across a
``("data", "model")`` :class:`~repro_torch.launch.mesh.DeviceMesh`, and
every request bucket is split over the **data** axis.  One process drives
every shard: each shard's work is launched on its own device (the kernel
wrappers take the device and the stream from their input tensors), every
shard is launched before any is waited on, and the results meet in one
host buffer.

Two placements, both equal bit for bit to the single-device engine
(``tests/test_torch_mesh.py``):

  * **replicated** (the default): the register image, with its sparsity
    image, lives once on every distinct device of the mesh, and only the
    batch is split over "data".  No row affects another, so each data
    shard classifies its rows alone.
  * **clause-sharded** (``shard_clauses=True``): the clause axis ``C`` of
    ``include`` / ``include_packed`` / ``nonempty`` and the ``C`` column
    axis of ``weights [m, C]`` are also split over "model".  Each device
    evaluates its clause shard and computes partial class sums with its
    weight columns; an exact int32 :func:`~repro_torch.distributed.collectives.psum_tree`
    over the row's model shards combines them (integer addition is
    associative, so Eq. (3) class sums stay bit-identical), and the argmax
    runs after the combine.  The active-clause set is not shard-uniform,
    so placement drops the sparsity image and sparse paths resolve to
    their dense fallbacks.

Batch divisibility: each data shard takes ``bucket / n_data`` rows, so the
engine's power-of-two buckets are clamped from below to the data-axis
size, which must itself be a power of two <= ``max_batch``.

A device may repeat in the mesh (``cuda:0`` four times on a one-card
machine, ``cpu`` in the tests): every meshed code path then runs, with
the shards one after the other on the one device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ingress import IngressSpec
from repro_torch.distributed.collectives import psum_tree
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.serve.paths import PACKED, Params, get_path, resolve_path
from repro_torch.serve.servable import ServableModel

__all__ = [
    "Placement",
    "ServeMesh",
    "classify_step_clause_sharded",
    "classify_step_meshed",
    "make_serve_mesh",
]


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A serving placement: a device mesh and a sharding mode.

    Hashable (it enters the autotuner's memo key).  ``mesh`` must carry a
    "data" axis; ``shard_clauses=True`` also requires a "model" axis, over
    which every registered model's clause pool is split (``n_clauses``
    must divide evenly, checked at placement).
    """

    mesh: DeviceMesh
    shard_clauses: bool = False

    def __post_init__(self):
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"ServeMesh needs a DeviceMesh; got {type(self.mesh).__name__}")
        names = self.mesh.axis_names
        if "data" not in names:
            raise ValueError(f'ServeMesh requires a "data" axis; mesh has {names}')
        if self.shard_clauses and "model" not in names:
            raise ValueError(f'shard_clauses=True requires a "model" axis; mesh has {names}')
        if len({d.type for d in self.mesh.flat}) != 1:
            raise ValueError(f"a ServeMesh's devices must be of one type; got {self.mesh.flat}")

    # --- geometry ---------------------------------------------------------

    @property
    def devices(self) -> int:
        """Grid positions of the mesh (a repeated device counts each time)."""
        return self.mesh.size

    @property
    def n_data(self) -> int:
        """Batch shards (the data-axis size)."""
        return self.mesh.shape["data"]

    @property
    def n_model(self) -> int:
        """Clause shards (1 when the mesh has no "model" axis)."""
        return self.mesh.shape.get("model", 1)

    @functools.cached_property
    def grid(self) -> Tuple[Tuple[torch.device, ...], ...]:
        """``grid[d][m]``: the device of data shard ``d``, model shard ``m``."""
        has_model = "model" in self.mesh.axis_names
        return tuple(
            tuple(self.mesh.device_at(data=d, **({"model": m} if has_model else {}))
                  for m in range(self.n_model))
            for d in range(self.n_data))

    @property
    def first_device(self) -> torch.device:
        return self.grid[0][0]

    @functools.cached_property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device of the mesh once, in row-major order."""
        return tuple(dict.fromkeys(self.mesh.flat))

    def shrunk(self) -> Optional["ServeMesh"]:
        """The next-smaller placement after losing devices on the data axis:
        half the batch shards, the model axis (and clause sharding) kept,
        on this mesh's surviving rows (so a hand-built mesh that repeats a
        device shrinks too).  None when the data axis is already 1."""
        if self.n_data <= 1:
            return None
        return ServeMesh(self.mesh.truncated("data", self.n_data // 2),
                         shard_clauses=self.shard_clauses)

    # --- placement --------------------------------------------------------

    def place_batch(self, arr) -> List[torch.Tensor]:
        """A padded bucket split over "data": one tensor of ``B / n_data``
        rows per data shard, on that row's first device (packed uint32
        words are viewed as int32).  From pinned host memory the copies do
        not wait.  ``B`` must divide by :attr:`n_data`; the engine's bucket
        clamp makes every dispatched bucket divide."""
        if isinstance(arr, np.ndarray):
            if arr.dtype == np.uint32:
                arr = arr.view(np.int32)
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if arr.shape[0] % self.n_data:
            raise ValueError(
                f"batch {arr.shape[0]} does not divide over {self.n_data} data shards")
        k = arr.shape[0] // self.n_data
        return [arr[d * k:(d + 1) * k].to(self.grid[d][0], non_blocking=True)
                for d in range(self.n_data)]

    def place_servable(self, servable: ServableModel) -> ServableModel:
        """Place a frozen model's register image on the mesh.

        Returns the whole image on the mesh's first device, stripped of its
        ``version`` stamp (a placed image is a dispatch image; the engine
        keeps the stamp), with its per-device shards in ``placement``.
        Replicated: one copy of the image, with its sparsity image, per
        distinct device (a repeated device shares one).  Clause-sharded:
        ``n_model`` clause slices of ``include``, ``include_packed``,
        ``nonempty`` and the weight columns, each made contiguous here,
        once, and put on its device; the sparsity image is dropped.  A
        ``tuned`` plan rides on the returned image either way.
        """
        servable = servable.replace(version=None, placement=None)
        if not self.shard_clauses:
            copies = {dev: servable.on(dev) for dev in self.distinct_devices}
            shards = tuple(tuple(copies[dev] for dev in row) for row in self.grid)
            home = copies[self.first_device]
            return home.replace(placement=Placement(self, shards))
        n_clauses = servable.n_clauses
        if n_clauses % self.n_model:
            raise ValueError(
                f"n_clauses={n_clauses} does not divide over {self.n_model} "
                f'"model" shards (clause sharding needs an even split)')
        home = servable.replace(sparsity=None).on(self.first_device)
        k = n_clauses // self.n_model
        made = {}
        for row in self.grid:
            for m, dev in enumerate(row):
                if (dev, m) not in made:
                    sl = slice(m * k, (m + 1) * k)
                    made[dev, m] = ServableModel(
                        home.include[sl].to(dev).contiguous(),
                        home.include_packed[sl].to(dev).contiguous(),
                        home.nonempty[sl].to(dev).contiguous(),
                        home.weights[:, sl].to(dev).contiguous(),
                        home.config,
                    )
        shards = tuple(tuple(made[dev, m] for m, dev in enumerate(row)) for row in self.grid)
        return home.replace(placement=Placement(self, shards))


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """A register image's shards on a :class:`ServeMesh`: ``shards[d][m]``
    is the image data shard ``d``, model shard ``m`` evaluates (the whole
    image when replicated; clause slice ``m`` when clause-sharded, whose
    ``config`` stays the whole model's)."""

    smesh: ServeMesh
    shards: Tuple[Tuple[ServableModel, ...], ...]


def make_serve_mesh(data: int = 1, model: int = 1, *,
                    shard_clauses: Optional[bool] = None) -> ServeMesh:
    """A :class:`ServeMesh` over the first ``data * model`` CUDA cards
    (``launch/mesh.py`` owns the device grid and says what to do with too
    few).  ``shard_clauses`` defaults to ``model > 1``: a mesh with a model
    axis is only useful clause-sharded."""
    from repro_torch.launch.mesh import make_serve_device_mesh

    if shard_clauses is None:
        shard_clauses = model > 1
    return ServeMesh(make_serve_device_mesh(data, model), shard_clauses=shard_clauses)


def _placement(servable: ServableModel, smesh: ServeMesh) -> Placement:
    placement = servable.placement
    if placement is None or placement.smesh != smesh:
        raise ValueError("the servable is not placed on this mesh "
                         "(ServeMesh.place_servable places it)")
    return placement


@torch.inference_mode()
def classify_step_clause_sharded(servable: ServableModel, xs: List[torch.Tensor],
                                 smesh: ServeMesh, path_name: str,
                                 ingress: Optional[IngressSpec] = None) -> List[torch.Tensor]:
    """The clause-sharded classify step on a placed servable and a placed
    batch (:meth:`ServeMesh.place_batch`); one int32 ``[B / n_data, 1 + m]``
    (predictions, class sums) per data shard, on that row's first device,
    without waiting.

    ``ingress=None`` takes literals; an :class:`IngressSpec` takes raw
    pixels, and the ingress runs once per data shard on that row's first
    device, in the evaluated path's literal form, before the literals are
    copied to the row's other model devices.  Each (data, model) device
    runs the path on its clause shard; the partial class sums of a row
    meet in :func:`psum_tree`, and the argmax runs after."""
    from repro_torch.serve.engine import _packed_result

    # Clause-sharded images carry no sparsity image: a sparse path name
    # resolves to its dense fallback.
    path = resolve_path(get_path(path_name), servable)
    shards = _placement(servable, smesh).shards
    if ingress is not None:
        ingress = dataclasses.replace(ingress, packed=path.input_form == PACKED)
    outs = []
    for row, devs, x in zip(shards, smesh.grid, xs):
        if ingress is not None:
            x = path.ingress_fn(ingress, x)
        lits = {}
        partial = []
        for shard, dev in zip(row, devs):
            if dev not in lits:
                lits[dev] = x.to(dev)
            partial.append(path.fn(lits[dev], shard.include, shard.include_packed,
                                   shard.nonempty, shard.weights))
        outs.append(_packed_result(psum_tree(partial)[0]))
    return outs


def classify_step_meshed(servable: ServableModel, xs: List[torch.Tensor], smesh: ServeMesh,
                         path_name: str, ingress: Optional[IngressSpec] = None,
                         params: Params = ()) -> List[torch.Tensor]:
    """The meshed classify step the engine and the autotuner run: one int32
    ``[B / n_data, 1 + m]`` per data shard, without waiting.  Replicated
    meshes run the engine's single-device step on each data shard's copy
    of the image (``params`` apply); clause-sharded meshes run
    :func:`classify_step_clause_sharded`, which takes no params."""
    from repro_torch.serve.engine import classify_raw_step, classify_step

    if smesh.shard_clauses:
        return classify_step_clause_sharded(servable, xs, smesh, path_name, ingress)
    shards = _placement(servable, smesh).shards
    if ingress is not None:
        return [classify_raw_step(row[0], x, path_name, ingress, params)
                for row, x in zip(shards, xs)]
    return [classify_step(row[0], x, path_name, params) for row, x in zip(shards, xs)]
