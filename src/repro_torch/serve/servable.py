"""ServableModel: the frozen register image of a ConvCoTM.

Counterpart of ``repro/serve/servable.py``.  ``freeze`` derives, once,
everything inference needs from a model: include bits, packed include
words, the nonempty mask and int8-clamped weights.  The image is an
``nn.Module`` whose tensors are registered buffers, so ``.to(device)``
moves it to the card once and every batch after touches literals only.

:func:`analyze_sparsity` attaches the active-clause image
(:class:`ClauseSparsity`, a submodule, so it moves with the servable) that
the sparse eval paths read.  A servable carries an optional lifecycle
stamp (:class:`ServableVersion`, the ``version`` attribute), whose
:func:`servable_digest` is the same string in both packages for the same
model, and an optional ``tuned`` plan
(:class:`~repro_torch.serve.autotune.TunedPlan`, the autotuner's winners
per request form and bucket).  An image placed on a device mesh carries
its per-device shards in ``placement``
(:class:`~repro_torch.serve.mesh.Placement`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import TYPE_CHECKING, Dict, Optional

import torch
from torch import nn

from repro_torch.core import clauses as cl
from repro_torch.core.cotm import WEIGHT_MAX, WEIGHT_MIN, CoTMConfig, CoTMModel
from repro_torch.core.patches import pack_bits

if TYPE_CHECKING:   # serve/autotune.py and serve/mesh.py import this module
    from repro_torch.serve.autotune import TunedPlan
    from repro_torch.serve.mesh import Placement

__all__ = [
    "ClauseSparsity",
    "ServableModel",
    "ServableVersion",
    "active_pad",
    "analyze_sparsity",
    "freeze",
    "servable_digest",
]


@dataclasses.dataclass(frozen=True)
class ServableVersion:
    """Identity stamp of one served model version: the engine-assigned
    monotonic id, the training cursor (epoch, step) the weights came from,
    and the content digest of the register image."""

    version: int = 0
    epoch: int = 0
    step: int = 0
    digest: str = ""

    def as_dict(self) -> Dict:
        return {"version": self.version, "epoch": self.epoch, "step": self.step,
                "digest": self.digest}

    @classmethod
    def from_dict(cls, d) -> "ServableVersion":
        """Parse a checkpoint-manifest stamp; a missing or malformed one
        gives the v0 stamp."""
        if not isinstance(d, dict):
            return cls()
        try:
            return cls(version=int(d.get("version", 0)), epoch=int(d.get("epoch", 0)),
                       step=int(d.get("step", 0)), digest=str(d.get("digest", "")))
        except (TypeError, ValueError):
            return cls()


def servable_digest(servable: "ServableModel") -> str:
    """Content hash (12 hex characters) of a frozen model: the config's
    repr, the include bits and the clamped weights, as the reference
    hashes them.  Equal digests classify identically."""
    h = hashlib.sha256()
    h.update(repr(servable.config).encode())
    h.update(servable.include.detach().cpu().contiguous().numpy().tobytes())
    h.update(servable.weights.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:12]


class ClauseSparsity(nn.Module):
    """The active-clause register image (empty clauses pruned).  Buffers,
    each with ``C_a = n_active`` rows on the clause axis:

      * ``active_idx``     int32 ``[C_a]`` indices into the full pool (-1:
        a synthetic pad row)
      * ``include``        uint8 0/1 ``[C_a, 2o]`` active include masks
      * ``include_packed`` int32 ``[C_a, W]`` packed include words
      * ``exclude_packed`` int32 ``[C_a, W]`` ``~include_packed``: the pad
        bits past 2o are set, so the sparse word test
        ``~(lit | exclude) == 0`` needs no valid-bit mask
      * ``include_counts`` int32 ``[C_a]`` includes per clause
      * ``weights``        int8 ``[m, C_a]`` active weight columns
    """

    active_idx: torch.Tensor
    include: torch.Tensor
    include_packed: torch.Tensor
    exclude_packed: torch.Tensor
    include_counts: torch.Tensor
    weights: torch.Tensor

    def __init__(self, active_idx, include, include_packed, exclude_packed,
                 include_counts, weights):
        super().__init__()
        for name, t in (("active_idx", active_idx), ("include", include),
                        ("include_packed", include_packed),
                        ("exclude_packed", exclude_packed),
                        ("include_counts", include_counts), ("weights", weights)):
            self.register_buffer(name, t)

    @property
    def n_active(self) -> int:
        return self.include.shape[0]

    @property
    def include_density(self) -> float:
        """Mean include fraction over active clauses (0 when none)."""
        if self.n_active == 0 or self.include.shape[1] == 0:
            return 0.0
        return float(self.include_counts.sum()) / (self.n_active * self.include.shape[1])


class ServableModel(nn.Module):
    """Frozen inference image.  Buffers:

      * ``include``        uint8 0/1 ``[C, 2o]`` TA action signals
      * ``include_packed`` int32 ``[C, W]`` packed include words
      * ``nonempty``       bool ``[C]`` empty-clause mask (Sec. IV-D)
      * ``weights``        int8 ``[m, C]`` clamped clause weights

    and the optional submodule ``sparsity`` (:func:`analyze_sparsity`);
    plain attributes ``config``, ``version`` (a :class:`ServableVersion`
    or None), ``tuned`` (a :class:`~repro_torch.serve.autotune.TunedPlan`
    or None) and ``placement`` (a :class:`~repro_torch.serve.mesh.Placement`,
    the image's shards on a mesh, or None).
    """

    include: torch.Tensor
    include_packed: torch.Tensor
    nonempty: torch.Tensor
    weights: torch.Tensor
    sparsity: Optional[ClauseSparsity]

    def __init__(self, include, include_packed, nonempty, weights, config: CoTMConfig,
                 sparsity: Optional[ClauseSparsity] = None, *,
                 version: Optional[ServableVersion] = None,
                 tuned: Optional["TunedPlan"] = None,
                 placement: Optional["Placement"] = None):
        super().__init__()
        self.register_buffer("include", include)
        self.register_buffer("include_packed", include_packed)
        self.register_buffer("nonempty", nonempty)
        self.register_buffer("weights", weights)
        self.register_module("sparsity", sparsity)
        self.config = config
        self.version = version
        self.tuned = tuned
        self.placement = placement

    @property
    def n_clauses(self) -> int:
        return self.include.shape[0]

    def replace(self, **changes) -> "ServableModel":
        """A new image with ``changes`` (``sparsity``, ``version``, ``tuned``,
        ``placement``) applied, sharing this one's tensors
        (``dataclasses.replace`` of the reference's frozen dataclass): no
        copy, no transfer."""
        kw = {"sparsity": self.sparsity, "version": self.version, "tuned": self.tuned,
              "placement": self.placement, **changes}
        return ServableModel(self.include, self.include_packed, self.nonempty, self.weights,
                             self.config, **kw)

    def on(self, device) -> "ServableModel":
        """This image on ``device``, as a new image: unlike ``nn.Module.to``
        it leaves this one (and its shared sparsity image) where it is.
        Tensors already on ``device`` are shared; ``placement`` is dropped."""
        sp = self.sparsity
        if sp is not None:
            sp = ClauseSparsity(*(getattr(sp, n).to(device) for n in (
                "active_idx", "include", "include_packed", "exclude_packed",
                "include_counts", "weights")))
        return ServableModel(self.include.to(device), self.include_packed.to(device),
                             self.nonempty.to(device), self.weights.to(device), self.config,
                             sp, version=self.version, tuned=self.tuned)

    @property
    def n_classes(self) -> int:
        return self.weights.shape[0]


def freeze(model: CoTMModel, config: CoTMConfig) -> ServableModel:
    """Prepare a ``CoTMModel`` for serving (one-time, per model), on the
    model's device."""
    include = model.include
    return ServableModel(
        include=include,
        include_packed=pack_bits(include),
        nonempty=cl.clause_nonempty(include),
        weights=torch.clamp(model.weights, WEIGHT_MIN, WEIGHT_MAX).to(torch.int8),
        config=config,
    )


def active_pad(n_active: int, n_clauses: int) -> int:
    """Pow2-binned active-row count: the next power of two >= ``n_active``,
    clamped to the pool size (0 stays 0)."""
    if n_active <= 0:
        return 0
    return min(1 << (n_active - 1).bit_length(), n_clauses)


def analyze_sparsity(
    servable: ServableModel, *, pad_to: Optional[int | str] = None
) -> ServableModel:
    """A servable with the active-clause image attached, on the servable's
    device; the tensors of ``servable`` are shared, not copied.

    Idempotent: a servable that has one is returned as it is.  A pool with
    no active clause gives zero-row tensors.  ``pad_to`` (an int >= the
    active count, or ``"pow2"`` for the :func:`active_pad` bin) appends
    synthetic rows: all-zero include, so an all-ones exclude that fires on
    every patch, a zero weight column, so no class sum changes, and
    ``active_idx`` -1.
    """
    if servable.sparsity is not None:
        return servable
    active = torch.nonzero(servable.nonempty.to(torch.bool)).flatten()
    n_active = active.numel()
    if pad_to == "pow2":
        pad_to = active_pad(n_active, servable.n_clauses)
    include = servable.include[active]                       # [C_a, 2o]
    # Packing is per clause row: the active rows' words are a row slice of
    # the freeze-time packing.
    include_packed = servable.include_packed[active]
    weights = servable.weights[:, active]
    active = active.to(torch.int32)
    if pad_to is not None:
        if pad_to < n_active:
            raise ValueError(
                f"pad_to={pad_to} < {n_active} active clauses; padding can only "
                f"grow the analysis"
            )
        pad = pad_to - n_active
        include = torch.cat([include, include.new_zeros((pad, include.shape[1]))])
        include_packed = torch.cat(
            [include_packed, include_packed.new_zeros((pad, include_packed.shape[1]))])
        weights = torch.cat([weights, weights.new_zeros((weights.shape[0], pad))], dim=1)
        active = torch.cat([active, active.new_full((pad,), -1)])
    sparsity = ClauseSparsity(
        active_idx=active,
        include=include.to(torch.uint8),
        include_packed=include_packed,
        exclude_packed=~include_packed,                      # pad bits -> 1
        include_counts=include.sum(dim=-1, dtype=torch.int32),
        weights=weights,
    )
    return servable.replace(sparsity=sparsity)
