"""Logical-axis sharding rules: the port's copy of ``repro/sharding/partition.py``.

Parameters and activations declare *logical* axes ("batch", "embed",
"mlp", ...); this module maps them onto the physical axes of whichever
mesh is active (the single-pod (16, 16) ("data", "model") production
mesh, the multi-pod (2, 16, 16) ("pod", "data", "model") mesh, or a small
test mesh), so model code never names a physical axis.

Rules (MaxText-style):
  batch   -> ("pod", "data")   data parallelism; the pod axis only ever
                               carries batch.
  fsdp    -> "data"            parameter / optimizer-state sharding (ZeRO).
  tensor  -> "model"           tensor parallelism (heads / mlp / vocab).
  expert  -> "model"           expert parallelism.
  seq     -> "model"           sequence sharding of long decode caches.
  clause  -> "model"           the TM clause pool (``serve/mesh.py``).
  (None)  -> replicated.

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of names; it stands where the reference has a ``PartitionSpec``,
entry for entry.  :class:`NamedSharding` pairs a spec with its mesh and
gives the shape each position holds.  The mesh is a
:class:`~repro_torch.launch.mesh.DeviceMesh` (anything with
``axis_names`` and a ``shape`` mapping will do).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

__all__ = [
    "LOGICAL_RULES",
    "NamedSharding",
    "PROFILES",
    "Spec",
    "get_profile",
    "logical_to_physical",
    "mesh_axis_size",
    "set_profile",
    "shard",
    "sharding_for",
    "single_device_mesh",
    "spec",
]

Axis = Union[str, None, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tensor": ("model",),
    "expert": ("model",),
    "seq": ("model",),
    "clause": ("model",),
    "replicated": (),
}

# Sharding profiles:
#   tp       - default: TP over "model", ZeRO over "data".
#   dp       - small archs: no tensor parallelism; params ZeRO-sharded over
#              both axes, batch over ("pod", "data").
#   serve_tp - decode: weights decode-resident, sharded over "model" only.
# "clause" maps to "model" in every profile.
PROFILES = {
    "tp": LOGICAL_RULES,
    "dp": {
        "batch": ("pod", "data"),
        "fsdp": ("data", "model"),
        "tensor": (),
        "expert": (),
        "seq": ("model",),
        "clause": ("model",),
        "replicated": (),
    },
    "serve_tp": {
        "batch": ("pod", "data"),
        "fsdp": (),
        "tensor": ("model",),
        "expert": ("model",),
        "seq": ("model",),
        "clause": ("model",),
        "replicated": (),
    },
}

_ACTIVE_PROFILE = "tp"


def set_profile(name: str) -> None:
    """Select the active sharding profile (process-wide, as in the
    reference: callers that change it restore it)."""
    global _ACTIVE_PROFILE, LOGICAL_RULES
    if name not in PROFILES:
        raise KeyError(f"unknown sharding profile {name}")
    _ACTIVE_PROFILE = name
    LOGICAL_RULES = PROFILES[name]


def get_profile() -> str:
    return _ACTIVE_PROFILE


def logical_to_physical(axis: Axis, mesh) -> Optional[Union[str, Tuple[str, ...]]]:
    """One logical axis -> the physical mesh axes present in ``mesh``."""
    if axis is None:
        return None
    names = tuple(mesh.axis_names)
    if isinstance(axis, tuple):
        out: list = []
        for a in axis:
            p = logical_to_physical(a, mesh)
            if p is None:
                continue
            out.extend(p if isinstance(p, tuple) else (p,))
        return tuple(out) if out else None
    phys = tuple(a for a in LOGICAL_RULES.get(axis, ()) if a in names)
    if not phys:
        return None
    return phys if len(phys) > 1 else phys[0]


def spec(logical: Sequence[Axis], mesh) -> Spec:
    """Logical axis tuple -> spec for ``mesh``."""
    return tuple(logical_to_physical(a, mesh) for a in logical)


def axes_of(entry: Axis) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _ways(mesh, entry: Axis) -> int:
    return math.prod(mesh.shape[a] for a in axes_of(entry))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on its mesh (``jax.sharding.NamedSharding``'s part)."""

    mesh: object = dataclasses.field(repr=False)
    spec: Spec = ()

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape each grid position holds of a ``shape`` array; every
        sharded dim must divide (``sharding_for`` drops those that do not)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(shape)}")
        out = []
        for i, dim in enumerate(shape):
            ways = _ways(self.mesh, self.spec[i]) if i < len(self.spec) else 1
            if dim % ways:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {ways} "
                                 f"positions ({self.spec[i]})")
            out.append(dim // ways)
        return tuple(out)


def shard(x, logical: Sequence[Axis], mesh):
    """The reference's ``with_sharding_constraint``: a no-op on a
    one-position mesh.  A meshed step places its shards explicitly
    (``sharding/blocks.py``), so this never moves data."""
    return x


def sharding_for(shape: Tuple[int, ...], logical: Sequence[Axis], mesh) -> NamedSharding:
    """The sharding of a concrete shape: logical axes whose mesh-axis
    product does not divide the dim are dropped (e.g. a global batch of 1
    cannot shard its batch axis)."""
    fixed = []
    for dim, axes in zip(shape, spec(logical, mesh)):
        ways = _ways(mesh, axes) if axes is not None else 0
        fixed.append(axes if (axes is not None and ways and dim % ways == 0) else None)
    return NamedSharding(mesh, tuple(fixed))


def mesh_axis_size(mesh, logical: str) -> int:
    """Product of the physical axis sizes a logical axis maps onto."""
    phys = logical_to_physical(logical, mesh)
    return 1 if phys is None else _ways(mesh, phys)


def single_device_mesh(device=None):
    """The one-position ``("data",)`` mesh of ``device`` (the card unless
    ``"cpu"`` is named)."""
    from repro_torch import resolve_device
    from repro_torch.launch.mesh import DeviceMesh

    return DeviceMesh((resolve_device(device),), ("data",))
