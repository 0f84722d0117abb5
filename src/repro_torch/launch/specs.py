"""Model declarations per arch: the serving part of ``repro/launch/specs.py``.

``model_decls`` picks the declaration tree of an arch (encoder-decoder or
decoder-only) and ``abstract_model`` lays it out on the meta device.  The
reference's batch, cache and train-state specs and their shardings belong
to the sharding half of the LM substrate and are not here yet.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tfm
from repro_torch.models.base import ParamTree, abstract_params

__all__ = ["abstract_model", "model_decls"]


def model_decls(cfg: ModelConfig, fan_in: bool = False) -> Dict:
    """The declaration tree of ``cfg``.  Its layers draw as the reference's
    stacked layers draw; with ``fan_in``, each layer with its own fan-in
    (std ``1/sqrt(d_in)``), the well-scaled weights the gradient checks
    are held on."""
    if cfg.is_encoder_decoder:
        return ed.encdec_decls(cfg, fan_in)
    return tfm.model_decls(cfg, fan_in)


def abstract_model(cfg: ModelConfig) -> ParamTree:
    return abstract_params(model_decls(cfg))
