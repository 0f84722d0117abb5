"""The paper's accelerator configuration served by the port (``--arch convcotm-mnist``).

28x28 images booleanized at threshold 75, 10x10 window at stride 1 ->
361 patches, 272 literals; 128 clauses, 10 classes, int8 weights
(paper Sec. III-D / IV).  Same values as ``repro/configs/convcotm.py``.
"""

from __future__ import annotations

from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.patches import PatchSpec

__all__ = ["COTM_CONFIGS", "BOOLEANIZE_METHOD"]

_PAPER_PATCH = PatchSpec(
    image_x=28, image_y=28, window_x=10, window_y=10, stride_x=1, stride_y=1,
    channels=1, therm_bits=1,
)

CONVCOTM_MNIST = CoTMConfig(n_clauses=128, n_classes=10, patch=_PAPER_PATCH, T=500, s=10.0)

BOOLEANIZE_METHOD = {"convcotm-mnist": "threshold"}

COTM_CONFIGS = {"convcotm-mnist": CONVCOTM_MNIST}
