"""Inference ingress: raw pixels -> literals, on the device that holds them.

Counterpart of ``repro/core/ingress.py``: :func:`apply_ingress` composes
booleanize -> patch extraction -> literals -> (optional) bit pack, so one
H2D copy of raw uint8 pixels feeds the whole classify step.  On the
packed route of a Z=U=1 geometry a CUDA tensor goes through the CUDA
ingress-pack kernel, which writes only the packed words to device memory
(as the reference drops into its Pallas kernel on the TPU); a CPU tensor
takes the plain composition.

Ported methods: ``threshold`` (MNIST) and ``none`` (inputs already
booleanized).  Adaptive-Gaussian and thermometer ingress are not ported
yet and are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.booleanize import threshold_booleanize
from repro_torch.core.patches import (
    PatchSpec,
    extract_patch_features,
    make_literals,
    pack_bits,
)
from repro_torch.kernels.ops import ingress_pack

__all__ = ["IngressSpec", "apply_booleanize", "apply_ingress", "raw_trailing_shape"]

_METHODS = ("threshold", "none")


@dataclasses.dataclass(frozen=True)
class IngressSpec:
    """Static description of one raw -> literals ingress.

    ``method``: 'threshold' or 'none'; ``packed`` selects the literal form
    of the target eval path (int32 words, or dense uint8 0/1).
    """

    patch: PatchSpec
    method: str = "threshold"
    packed: bool = True
    threshold: int = 75

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(
                f"booleanization method {self.method!r} is not ported; "
                f"expected one of {_METHODS}"
            )


def raw_trailing_shape(spec: IngressSpec) -> Tuple[int, ...]:
    """Expected trailing dims of a raw input batch for this ingress:
    ``[Y, X]``, plus ``Z`` for multi-channel geometries, plus ``U`` for
    pre-booleanized thermometer inputs."""
    p = spec.patch
    shape: Tuple[int, ...] = (p.image_y, p.image_x)
    if p.channels > 1:
        shape += (p.channels,)
    if spec.method == "none" and p.therm_bits > 1:
        shape += (p.therm_bits,)
    return shape


def apply_booleanize(spec: IngressSpec, raw: torch.Tensor) -> torch.Tensor:
    if spec.method == "none":
        return raw.to(torch.uint8)
    return threshold_booleanize(raw, spec.threshold)


def _with_feature_axes(bits: torch.Tensor, patch: PatchSpec) -> torch.Tensor:
    """Normalize booleanized bits to ``[B, Y, X, Z, U]``, using the patch
    spec to tell a trailing channel axis from a thermometer axis."""
    if bits.dim() == 5:
        return bits
    if bits.dim() == 3:
        return bits[..., None, None]
    if bits.dim() != 4:
        raise ValueError(f"booleanized input must be 3-5D, got {bits.dim()}D")
    if patch.therm_bits > 1 and patch.channels == 1 and bits.shape[-1] == patch.therm_bits:
        return bits[..., None, :]
    if patch.channels > 1 and patch.therm_bits == 1 and bits.shape[-1] == patch.channels:
        return bits[..., :, None]
    raise ValueError(
        f"cannot map trailing dim {bits.shape[-1]} onto (Z={patch.channels}, "
        f"U={patch.therm_bits})"
    )


def apply_ingress(spec: IngressSpec, raw: torch.Tensor) -> torch.Tensor:
    """Raw pixels -> dense uint8 ``[B, P, 2o]`` or packed int32 ``[B, P, W]``
    literals, on ``raw``'s device."""
    bits = _with_feature_axes(apply_booleanize(spec, raw), spec.patch)
    if spec.packed and spec.patch.channels == 1 and spec.patch.therm_bits == 1:
        return ingress_pack(bits[..., 0, 0].contiguous(), spec.patch)
    lits = make_literals(extract_patch_features(bits, spec.patch))
    if spec.packed:
        return pack_bits(lits, spec.patch.n_words)
    return lits
