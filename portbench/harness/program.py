"""The system under test: ``repro_torch``'s serving engine with the
cell's model registered on the configuration's eval path.

Imports of the port happen here and in the load generators only, after
the harness has checked for the card.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["build_engine"]


def build_engine(cfg: Dict, name: str, ta_state: np.ndarray, weights: np.ndarray, device):
    """A ``ServingEngine(max_batch=cfg['max_batch'])`` on ``device`` with the
    model (TA states, weights) registered under ``name`` on
    ``cfg['eval_path']`` and the configuration's booleanize."""
    import torch

    from repro_torch.core.cotm import CoTMConfig, CoTMModel
    from repro_torch.core.patches import PatchSpec
    from repro_torch.serve.engine import ServingEngine

    spec = PatchSpec(image_x=cfg["image_x"], image_y=cfg["image_y"],
                     window_x=cfg["window_x"], window_y=cfg["window_y"],
                     stride_x=cfg["stride_x"], stride_y=cfg["stride_y"],
                     channels=1, therm_bits=1)
    config = CoTMConfig(n_clauses=cfg["n_clauses"], n_classes=cfg["n_classes"], patch=spec,
                        eval_path=cfg["eval_path"])
    model = CoTMModel(ta_state=torch.from_numpy(np.ascontiguousarray(ta_state)),
                      weights=torch.from_numpy(np.ascontiguousarray(weights)))
    boolz = dict(cfg["booleanize"])
    method = boolz.pop("method")
    engine = ServingEngine(max_batch=cfg["max_batch"], device=device)
    engine.register(name, model, config, booleanize_method=method, path=cfg["eval_path"],
                    booleanize_kw=boolz)
    return engine
