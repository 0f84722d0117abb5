"""Inference ingress: raw pixels -> literals, on the device that holds them.

Counterpart of ``repro/core/ingress.py``: :func:`apply_ingress` composes
booleanize -> patch extraction -> literals -> (optional) bit pack, so one
H2D copy of raw uint8 pixels feeds the whole classify step.  On the
packed route of a Z=U=1 geometry a CUDA tensor goes through the CUDA
ingress-pack kernel, which writes only the packed words to device memory
(as the reference drops into its Pallas kernel on the TPU); a CPU tensor
takes the plain composition.  Raw uint8 pixels on a card under the
adaptive method skip the separate booleanize too: the kernel's adaptive
mode takes them to packed words in one launch
(:func:`uses_adaptive_kernel`).

Methods: ``threshold`` (MNIST), ``adaptive`` (alias
``adaptive_gaussian``; FMNIST/KMNIST), ``thermometer`` (scaled-up
configurations) and ``none`` (inputs already booleanized).  The packed
route of a Z=U=1 geometry feeds the booleanized bits of any method to the
ingress-pack kernel; multi-channel and thermometer geometries take the
plain composition on both devices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.booleanize import (
    adaptive_gaussian_booleanize,
    thermometer_encode,
    threshold_booleanize,
)
from repro_torch.core.patches import (
    PatchSpec,
    extract_patch_features,
    make_literals,
    pack_bits,
)
from repro_torch.kernels.ingress import MAX_TAPS
from repro_torch.kernels.ops import ingress_pack, ingress_pack_adaptive
from repro_torch.spans import span

__all__ = [
    "IngressSpec",
    "apply_booleanize",
    "apply_ingress",
    "device_ingress",
    "raw_trailing_shape",
    "uses_adaptive_kernel",
]

#: Method aliases: the paper's FMNIST/KMNIST preprocessing is OpenCV's
#: adaptiveThreshold with a Gaussian window; both spellings are one method.
_METHOD_ALIASES = {"adaptive_gaussian": "adaptive"}
_METHODS = ("threshold", "adaptive", "thermometer", "none")


@dataclasses.dataclass(frozen=True)
class IngressSpec:
    """Static description of one raw -> literals ingress.

    ``method``: 'threshold', 'adaptive'/'adaptive_gaussian',
    'thermometer' or 'none'; ``packed`` selects the literal form of the
    target eval path (int32 words, or dense uint8 0/1).  ``threshold``,
    ``block_size``/``c`` and ``levels`` are the knobs of the threshold,
    adaptive and thermometer methods.
    """

    patch: PatchSpec
    method: str = "threshold"
    packed: bool = True
    threshold: int = 75
    block_size: int = 11
    c: float = 2.0
    levels: int = 1

    def __post_init__(self):
        m = _METHOD_ALIASES.get(self.method, self.method)
        if m not in _METHODS:
            raise ValueError(
                f"unknown booleanization method {self.method!r}; "
                f"expected one of {_METHODS} (or 'adaptive_gaussian')"
            )
        if m == "thermometer" and self.levels != self.patch.therm_bits:
            raise ValueError(
                f"thermometer levels={self.levels} must equal the patch "
                f"spec's therm_bits={self.patch.therm_bits}"
            )

    @property
    def resolved_method(self) -> str:
        return _METHOD_ALIASES.get(self.method, self.method)


def raw_trailing_shape(spec: IngressSpec) -> Tuple[int, ...]:
    """Expected trailing dims of a raw input batch for this ingress:
    ``[Y, X]``, plus ``Z`` for multi-channel geometries, plus ``U`` for
    pre-booleanized thermometer inputs (the thermometer method makes U
    itself, so its raw input has none)."""
    p = spec.patch
    shape: Tuple[int, ...] = (p.image_y, p.image_x)
    if p.channels > 1:
        shape += (p.channels,)
    if spec.resolved_method == "none" and p.therm_bits > 1:
        shape += (p.therm_bits,)
    return shape


def apply_booleanize(spec: IngressSpec, raw: torch.Tensor) -> torch.Tensor:
    """The booleanize stage of the ingress, on ``raw``'s device."""
    m = spec.resolved_method
    if m == "none":
        return raw.to(torch.uint8)
    if m == "threshold":
        return threshold_booleanize(raw, spec.threshold)
    if m == "adaptive":
        return adaptive_gaussian_booleanize(raw, spec.block_size, spec.c)
    # thermometer: appends the U axis (dropped again for one level).
    out = thermometer_encode(raw, spec.levels)
    if spec.levels == 1:
        out = out[..., 0]
    return out


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


def uses_adaptive_kernel(spec: IngressSpec, raw: torch.Tensor) -> bool:
    """Whether :func:`apply_ingress` hands ``raw`` whole to the ingress-pack
    kernel's adaptive mode: raw uint8 pixels on a card, the adaptive method,
    the packed form of a Z=U=1 geometry, and a window the launch holds.
    Any other input booleanizes first, as the reference does."""
    p = spec.patch
    return (raw.is_cuda and raw.dtype == torch.uint8 and spec.resolved_method == "adaptive"
            and spec.packed and p.channels == 1 and p.therm_bits == 1
            and spec.block_size <= MAX_TAPS)


def apply_ingress(spec: IngressSpec, raw: torch.Tensor) -> torch.Tensor:
    """Raw pixels -> dense uint8 ``[B, P, 2o]`` or packed int32 ``[B, P, W]``
    literals, on ``raw``'s device."""
    if uses_adaptive_kernel(spec, raw):
        with span("ingress.pack"):
            return ingress_pack_adaptive(raw, spec.patch, spec.block_size, spec.c)
    with span("ingress.booleanize"):
        bits = _with_feature_axes(apply_booleanize(spec, raw), spec.patch)
    with span("ingress.pack"):
        if spec.packed and spec.patch.channels == 1 and spec.patch.therm_bits == 1:
            return ingress_pack(bits[..., 0, 0].contiguous(), spec.patch)
        lits = make_literals(extract_patch_features(bits, spec.patch))
        if spec.packed:
            return pack_bits(lits, spec.patch.n_words)
        return lits


#: The standalone ingress of the reference (raw -> literals in one call),
#: which the training engine's dataset freezing uses.  Plain here: there
#: is no graph to compile, so it is :func:`apply_ingress` itself.
device_ingress = apply_ingress
