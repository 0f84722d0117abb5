"""TM Composites: several ConvCoTM specialists vote (counterpart of
``repro/core/composites.py``).

Each specialist is a ConvCoTM with its own booleanization and window
geometry.  Per image the specialists' class sums are normalised,
``v / max(max_i |v_i|, 1)`` in float32, summed in specialist order, and
argmax'd (the paper's Table III scale-up).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core.cotm import CoTMConfig, CoTMModel, infer

__all__ = ["CompositeConfig", "CompositeModel", "composite_infer"]


@dataclasses.dataclass(frozen=True)
class CompositeConfig:
    specialists: Tuple[CoTMConfig, ...]

    @property
    def n_classes(self) -> int:
        return self.specialists[0].n_classes


@dataclasses.dataclass
class CompositeModel:
    members: Tuple[CoTMModel, ...]


def composite_infer(
    model: CompositeModel, views: Sequence[torch.Tensor], config: CompositeConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite prediction from one booleanized view per specialist;
    returns (predictions int32 ``[B]``, composite class sums float32
    ``[B, m]``)."""
    if len(views) != len(config.specialists):
        raise ValueError("one view per specialist required")
    total = None
    for member, view, cfg in zip(model.members, views, config.specialists):
        _, v = infer(member, view, cfg)
        v = v.to(torch.float32)
        # A tensor divisor on v's device: a true float32 division on both
        # devices (no reciprocal of a host scalar).
        denom = torch.clamp(v.abs().amax(dim=-1, keepdim=True), min=1.0)
        vn = v / denom
        total = vn if total is None else total + vn
    return torch.argmax(total, dim=-1).to(torch.int32), total
