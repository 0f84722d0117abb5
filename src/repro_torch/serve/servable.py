"""ServableModel: the frozen register image of a ConvCoTM.

Counterpart of ``repro/serve/servable.py``.  ``freeze`` derives, once,
everything inference needs from a model: include bits, packed include
words, the nonempty mask and int8-clamped weights.  The image is an
``nn.Module`` whose tensors are registered buffers, so ``.to(device)``
moves it to the card once and every batch after touches literals only.

Sparsity analysis, version stamps and digests are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import clauses as cl
from repro_torch.core.cotm import WEIGHT_MAX, WEIGHT_MIN, CoTMConfig, CoTMModel
from repro_torch.core.patches import pack_bits

__all__ = ["ServableModel", "freeze"]


class ServableModel(nn.Module):
    """Frozen inference image.  Buffers:

      * ``include``        uint8 0/1 ``[C, 2o]`` TA action signals
      * ``include_packed`` int32 ``[C, W]`` packed include words
      * ``nonempty``       bool ``[C]`` empty-clause mask (Sec. IV-D)
      * ``weights``        int8 ``[m, C]`` clamped clause weights
    """

    include: torch.Tensor
    include_packed: torch.Tensor
    nonempty: torch.Tensor
    weights: torch.Tensor

    def __init__(self, include, include_packed, nonempty, weights, config: CoTMConfig):
        super().__init__()
        self.register_buffer("include", include)
        self.register_buffer("include_packed", include_packed)
        self.register_buffer("nonempty", nonempty)
        self.register_buffer("weights", weights)
        self.config = config

    @property
    def n_clauses(self) -> int:
        return self.include.shape[0]

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
