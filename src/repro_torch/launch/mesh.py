"""Device meshes (counterpart of ``repro/launch/mesh.py``).

:class:`DeviceMesh` stands in for ``jax.sharding.Mesh``: a grid of
``torch.device`` s with named axes, driven by one process.  Every shard of
a meshed step names its device explicitly, and the exact int32
reductions between shards are device-to-device copies and adds
(``distributed/collectives.py``); there is no ``torch.distributed``
process group.

A device may appear more than once in the grid.  That is this package's
counterpart of the reference's forced host device count
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``): ``cpu``
repeated gives the tests N devices, and ``cuda:0`` repeated runs every
meshed code path on a one-card machine.  Shards that share a device run
one after the other on it, so such a mesh shows the meshed paths right,
not their scaling across cards.

The LM's production meshes (:func:`make_production_mesh`) are the
reference's (16, 16) and (2, 16, 16) grids over the ``meta`` device by
default: the dry-run lays out shapes on them and allocates nothing.
Nothing here touches the devices when the module is imported.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device

__all__ = [
    "DeviceMesh",
    "make_production_mesh",
    "make_serve_device_mesh",
    "make_test_mesh",
    "required_devices",
]


def _depth(grid) -> int:
    d = 0
    while isinstance(grid, tuple):
        if not grid:
            raise ValueError("a DeviceMesh axis must hold at least one device")
        grid, d = grid[0], d + 1
    return d


def _normalise(grid):
    """Nested sequences -> nested tuples of ``torch.device``."""
    if isinstance(grid, (list, tuple)):
        return tuple(_normalise(g) for g in grid)
    return resolve_device(grid)


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s part in
    the reference).

    ``devices`` nests one sequence level per axis (``[[d00, d01], [d10,
    d11]]`` for a ``("data", "model")`` grid; ``[d0, d1]`` for one axis);
    entries are ``torch.device`` s or strings, and one device may repeat.
    Frozen and hashable: a mesh enters the autotuner's memo key.
    """

    devices: Tuple
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        grid = _normalise(self.devices)
        if not isinstance(grid, tuple):
            raise ValueError("DeviceMesh devices must be a (nested) sequence of devices")
        names = tuple(self.axis_names)
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        if _depth(grid) != len(names):
            raise ValueError(f"devices nest {_depth(grid)} levels deep but the mesh names "
                             f"{len(names)} axes {names}")
        sizes, level = [], grid
        for _ in names:
            sizes.append(len(level))
            level = level[0]

        def rectangular(g, k):
            return k == len(sizes) or (len(g) == sizes[k] and all(
                rectangular(x, k + 1) for x in g))

        if not rectangular(grid, 0):
            raise ValueError("DeviceMesh devices must form a rectangular grid")
        object.__setattr__(self, "devices", grid)
        object.__setattr__(self, "axis_names", names)

    @functools.cached_property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        sizes, level = {}, self.devices
        for name in self.axis_names:
            sizes[name] = len(level)
            level = level[0]
        return sizes

    @property
    def size(self) -> int:
        """Grid positions (a repeated device counts each time)."""
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def device_at(self, **index: int) -> torch.device:
        """The device at the named axis indices (an axis not named: 0)."""
        if unknown := set(index) - set(self.axis_names):
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; mesh has {self.axis_names}")
        g = self.devices
        for name in self.axis_names:
            g = g[index.get(name, 0)]
        return g

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """Every grid position's device, in row-major order."""
        out, stack = [], [self.devices]
        while stack:
            g = stack.pop()
            if isinstance(g, tuple):
                stack.extend(reversed(g))
            else:
                out.append(g)
        return tuple(out)

    def along(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis``, at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes {self.axis_names}")
        return tuple(self.device_at(**{axis: i}) for i in range(self.shape[axis]))

    def truncated(self, axis: str, n: int) -> "DeviceMesh":
        """The first ``n`` positions of ``axis``, every other axis kept."""
        k = self.axis_names.index(axis)

        def cut(g, level):
            return g[:n] if level == k else tuple(cut(x, level + 1) for x in g)

        return DeviceMesh(cut(self.devices, 0), self.axis_names)


def required_devices(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """(16, 16) ``("data", "model")`` single pod; (2, 16, 16) ``("pod",
    "data", "model")`` for two pods.  Every position holds ``device``
    (``meta`` by default: shapes only)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = torch.device("meta") if device is None else resolve_device(device)
    for n in reversed(shape):
        grid = (grid,) * n
    return DeviceMesh(grid, axes)


def make_serve_device_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the first ``data * model`` CUDA
    cards, each once: the device grid under
    :class:`~repro_torch.serve.mesh.ServeMesh`.  Raises with a hint when
    the machine has too few cards; a mesh that repeats a device (``cuda:0``
    four times on a one-card machine, or ``cpu``) is built explicitly with
    :class:`DeviceMesh` or :func:`make_test_mesh`."""
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1; got data={data} model={model}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"mesh ({data} data x {model} model) needs {n} CUDA devices but the "
            f"machine has {have}; to run the meshed paths on fewer devices, build "
            f"the grid with one device repeated: DeviceMesh([['cuda:0'] * {model}] * "
            f"{data}), make_test_mesh({data}, {model}, device=...), or the launcher's "
            f"--device with --mesh"
        )
    devs = [torch.device("cuda", i) for i in range(n)]
    return DeviceMesh(tuple(tuple(devs[d * model:(d + 1) * model]) for d in range(data)))


def make_test_mesh(data: int = 1, model: int = 1, *, device="cpu") -> DeviceMesh:
    """A small ``("data", "model")`` mesh of one device repeated (tests,
    and the meshed paths on a one-card machine)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1; got data={data} model={model}")
    dev = resolve_device(device)
    return DeviceMesh(((dev,) * model,) * data)

