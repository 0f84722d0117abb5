"""Booleanization of images (counterpart of ``repro/core/booleanize.py``).

The paper's MNIST setting is a fixed threshold: pixel > 75 -> 1.  The
adaptive-Gaussian and thermometer methods are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["threshold_booleanize"]


def threshold_booleanize(images: torch.Tensor, threshold: int = 75) -> torch.Tensor:
    """Pixels strictly greater than ``threshold`` become 1; uint8 0/1, same shape.
    (A bool tensor is one byte of 0/1: it is viewed as uint8, not converted.)"""
    return (images > threshold).view(torch.uint8)
