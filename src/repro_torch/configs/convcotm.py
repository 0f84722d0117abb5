"""The paper's accelerator configurations (``--arch convcotm-*``).

28x28 images, 10x10 window at stride 1 -> 361 patches, 272 literals; 128
clauses, 10 classes, int8 weights (paper Sec. III-D / IV).  MNIST is
booleanized at threshold 75, FMNIST and KMNIST with the adaptive
Gaussian method.  ``CIFAR10_COMPOSITES`` is the envisaged Table III
scale-up: four specialists of 1,000 clauses, literal budget 16.  Same
values as ``repro/configs/convcotm.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.composites import CompositeConfig
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.patches import PatchSpec

__all__ = ["COTM_CONFIGS", "BOOLEANIZE_METHOD", "CIFAR10_COMPOSITES"]

_PAPER_PATCH = PatchSpec(
    image_x=28, image_y=28, window_x=10, window_y=10, stride_x=1, stride_y=1,
    channels=1, therm_bits=1,
)

CONVCOTM_MNIST = CoTMConfig(n_clauses=128, n_classes=10, patch=_PAPER_PATCH, T=500, s=10.0)
CONVCOTM_FMNIST = dataclasses.replace(CONVCOTM_MNIST)
CONVCOTM_KMNIST = dataclasses.replace(CONVCOTM_MNIST)

BOOLEANIZE_METHOD = {
    "convcotm-mnist": "threshold",
    "convcotm-fmnist": "adaptive",
    "convcotm-kmnist": "adaptive",
}

COTM_CONFIGS = {
    "convcotm-mnist": CONVCOTM_MNIST,
    "convcotm-fmnist": CONVCOTM_FMNIST,
    "convcotm-kmnist": CONVCOTM_KMNIST,
}


def _spec(window: int, therm_bits: int) -> PatchSpec:
    return PatchSpec(
        image_x=32, image_y=32, window_x=window, window_y=window,
        stride_x=1, stride_y=1, channels=3, therm_bits=therm_bits,
    )


_SPECIALISTS = (
    CoTMConfig(n_clauses=1000, n_classes=10, patch=_spec(4, 4), T=1500, s=10.0,
               max_included_literals=16),
    CoTMConfig(n_clauses=1000, n_classes=10, patch=_spec(3, 3), T=1500, s=10.0,
               max_included_literals=16),
    CoTMConfig(n_clauses=1000, n_classes=10, patch=_spec(32, 1), T=1500, s=10.0,
               max_included_literals=16),   # whole image (HOG-specialist stand-in)
    CoTMConfig(n_clauses=1000, n_classes=10, patch=_spec(10, 1), T=1500, s=10.0,
               max_included_literals=16),   # 10x10 adaptive-thresholding specialist
)

CIFAR10_COMPOSITES = CompositeConfig(specialists=_SPECIALISTS)
