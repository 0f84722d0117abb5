"""Booleanization of images (counterpart of ``repro/core/booleanize.py``).

  * MNIST: a fixed threshold, pixel > 75 -> 1 (U = 1 bit per pixel).
  * FMNIST / KMNIST: adaptive Gaussian thresholding, pixel -> 1 iff
    pixel > gaussian_local_mean(pixel) - c (OpenCV's
    ``adaptiveThreshold`` with a Gaussian window).
  * Thermometer encoding, U bits per value, for the scaled-up
    TM-Composites configurations.

Every function runs on the device of its input.  The adaptive local mean
is float32 and a pixel near ``local_mean - c`` is decided by its last
bit, so the separable Gaussian sum is written out as shifted-slice
products and additions in one fixed order (:func:`_window_sum`): the
order in which the reference's ``jnp.convolve`` adds its window on the
CPU.  Each product and each addition is its own rounded float32 op,
which the card and the CPU compute alike; no convolution library call
(whose order, and on the card whose TF32 mode, would change bits) is
involved.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "adaptive_gaussian_booleanize",
    "booleanize",
    "gaussian_kernel1d",
    "thermometer_encode",
    "thermometer_thresholds",
    "threshold_booleanize",
]


def threshold_booleanize(images: torch.Tensor, threshold: int = 75) -> torch.Tensor:
    """Pixels strictly greater than ``threshold`` become 1; uint8 0/1, same shape.
    (A bool tensor is one byte of 0/1: it is viewed as uint8, not converted.)"""
    return (images > threshold).view(torch.uint8)


def gaussian_kernel1d(size: int, sigma: Optional[float] = None) -> np.ndarray:
    """1-D Gaussian window matching OpenCV's ``getGaussianKernel`` default
    sigma for ``size``: 0.3 * ((size - 1) * 0.5 - 1) + 0.8.  float32."""
    if sigma is None or sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _reduce8(lanes: List[torch.Tensor]) -> torch.Tensor:
    """The 8-lane horizontal sum: ((l0 + l1) + (l4 + l5)) + ((l2 + l3) + (l6 + l7))."""
    return ((lanes[0] + lanes[1]) + (lanes[4] + lanes[5])) + (
        (lanes[2] + lanes[3]) + (lanes[6] + lanes[7]))


def _fma(a: torch.Tensor, k: float, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``a * k + acc`` rounded once, as a fused multiply-add.

    The product is exact in float64 (24-bit by 24-bit mantissas).  The
    float64 sum is rounded to odd: a two-sum gives its exact error, and an
    inexact sum whose last bit is even moves one step toward the exact
    value.  A round-to-odd value with 53 >= 24 + 2 bits rounds to float32
    as the exact value would, so the second rounding does no harm."""
    p = a.double() * k
    b = acc.double()
    s = p + b
    bb = s - p
    err = (p - (s - bb)) + (b - bb)                  # exact: p + b == s + err
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _window_sum(xp: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """``sum_j xp[i + j] * k[j]`` along ``axis`` (valid positions only), in
    the reference's float32 order: the window is cut into blocks of 16
    (two 8-lane packets chained with fused multiply-adds, one accumulator
    per lane, then :func:`_reduce8`), then one block each of 8 (its own
    :func:`_reduce8`), 4 (``(p0 + p1) + (p2 + p3)``), 2 and 1; each block's
    sum is added to the running total in that order."""
    size = len(k)
    n = xp.shape[axis] - size + 1
    kk = [float(v) for v in k]                  # exact float32 values

    def prod(j):
        return xp.narrow(axis, j, n) * kk[j]

    total = None
    j = 0
    n16 = size // 16 * 16
    if n16:
        lanes = [prod(i) for i in range(8)]
        for jj in range(8, n16):
            lanes[jj % 8] = _fma(xp.narrow(axis, jj, n), kk[jj], lanes[jj % 8])
        total = _reduce8(lanes)
        j = n16
    for width in (8, 4, 2, 1):
        if size - j < width:
            continue
        if width == 8:
            part = _reduce8([prod(j + i) for i in range(8)])
        elif width == 4:
            part = (prod(j) + prod(j + 1)) + (prod(j + 2) + prod(j + 3))
        elif width == 2:
            part = prod(j) + prod(j + 1)
        else:
            part = prod(j)
        total = part if total is None else total + part
        j += width
    return total


def _edge_pad(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, x.shape[axis] - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = pad
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=axis)


def adaptive_gaussian_booleanize(
    images: torch.Tensor, block_size: int = 11, c: float = 2.0
) -> torch.Tensor:
    """Adaptive Gaussian thresholding (the paper's FMNIST/KMNIST setting).

    pixel -> 1 iff pixel > local_mean - c, the local mean a separable
    ``block_size`` Gaussian with edge replication, rows first, then
    columns.  ``images``: ``[..., H, W]``; returns uint8 0/1 of the same
    shape."""
    if block_size % 2 != 1:
        raise ValueError(f"block_size must be odd, got {block_size}")
    x = images.to(torch.float32)
    batch_shape = x.shape[:-2]
    h, w = x.shape[-2:]
    x2 = x.reshape((-1, h, w))
    k = gaussian_kernel1d(block_size)
    pad = block_size // 2
    rows = _window_sum(_edge_pad(x2, pad, 1), k, 1)
    local_mean = _window_sum(_edge_pad(rows, pad, 2), k, 2)
    c32 = torch.full((), c, dtype=torch.float32, device=x.device)   # no host copy
    out = (x2 > (local_mean - c32)).to(torch.uint8)
    return out.reshape(batch_shape + (h, w))


def thermometer_thresholds(levels: int, lo: float = 0.0, hi: float = 255.0) -> np.ndarray:
    """Evenly spaced interior thresholds of a ``levels``-bit thermometer."""
    return np.linspace(lo, hi, levels + 2)[1:-1].astype(np.float32)


def thermometer_encode(
    images: torch.Tensor, levels: int, lo: float = 0.0, hi: float = 255.0
) -> torch.Tensor:
    """Thermometer code with ``levels`` bits per value: shape
    ``images.shape + (levels,)``, bit u set iff value > threshold u."""
    th = torch.from_numpy(thermometer_thresholds(levels, lo, hi)).to(images.device)
    return (images.to(torch.float32)[..., None] > th).to(torch.uint8)


def booleanize(
    images: torch.Tensor,
    method: str = "threshold",
    threshold: int = 75,
    block_size: int = 11,
    c: float = 2.0,
    levels: int = 1,
) -> torch.Tensor:
    """Dispatch on ``method``: 'threshold' (MNIST), 'adaptive' (alias
    'adaptive_gaussian'; FMNIST/KMNIST), 'thermometer'.  Returns
    ``[..., H, W]``, or ``[..., H, W, U]`` for a thermometer of more than
    one level."""
    if method == "threshold":
        return threshold_booleanize(images, threshold)
    if method in ("adaptive", "adaptive_gaussian"):
        return adaptive_gaussian_booleanize(images, block_size, c)
    if method == "thermometer":
        out = thermometer_encode(images, levels)
        if levels == 1:
            out = out[..., 0]
        return out
    raise ValueError(f"unknown booleanization method: {method}")
