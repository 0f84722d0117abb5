"""Patch generation for the convolutional coalesced Tsetlin machine.

Counterpart of ``repro/core/patches.py``; same geometry, same literal
order:

  * a ``Wx x Wy`` window slides over the ``X x Y`` booleanized image with
    strides ``(dx, dy)``; x fastest, then y (patch b = y_pos * Bx + x_pos);
  * per patch the feature vector is [window bits (row-major wy, wx, z, u),
    y-position thermometer (Y - Wy bits), x-position thermometer
    (X - Wx bits)];
  * literals are [features, 1 - features] and pack LSB-first into 32-bit
    words.

Packed words are carried as **int32 bit patterns**: ``torch.uint32``
lacks ``~``, ``<<`` and ``>>`` on the CPU.  A word's bits are those of the
reference's uint32 word (``numpy.view(np.uint32)`` converts).  int32
``>>`` is arithmetic, so every right shift is masked.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "PatchSpec",
    "extract_patch_features",
    "make_literals",
    "pack_bits",
    "unpack_bits",
]


@dataclasses.dataclass(frozen=True)
class PatchSpec:
    """Static geometry of the convolution (paper Sec. III-C)."""

    image_x: int = 28          # X: columns
    image_y: int = 28          # Y: rows
    window_x: int = 10         # Wx
    window_y: int = 10         # Wy
    stride_x: int = 1          # dx
    stride_y: int = 1          # dy
    channels: int = 1          # Z
    therm_bits: int = 1        # U

    @property
    def bx(self) -> int:
        return 1 + (self.image_x - self.window_x) // self.stride_x

    @property
    def by(self) -> int:
        return 1 + (self.image_y - self.window_y) // self.stride_y

    @property
    def n_patches(self) -> int:
        """B = Bx * By (361 for the paper's 28x28 / 10x10 / stride 1)."""
        return self.bx * self.by

    @property
    def n_window_features(self) -> int:
        return self.window_x * self.window_y * self.channels * self.therm_bits

    @property
    def n_pos_y_bits(self) -> int:
        return self.image_y - self.window_y

    @property
    def n_pos_x_bits(self) -> int:
        return self.image_x - self.window_x

    @property
    def n_features(self) -> int:
        """o in Eq. (5); 136 for the paper's configuration."""
        return self.n_window_features + self.n_pos_y_bits + self.n_pos_x_bits

    @property
    def n_literals(self) -> int:
        """2o; 272 for the paper's configuration."""
        return 2 * self.n_features

    @property
    def n_words(self) -> int:
        """32-bit words per packed literal vector (9 for the paper)."""
        return (self.n_literals + 31) // 32

    def validate(self) -> None:
        if (self.image_x - self.window_x) % self.stride_x:
            raise ValueError("window/stride does not tile image in x")
        if (self.image_y - self.window_y) % self.stride_y:
            raise ValueError("window/stride does not tile image in y")


@functools.lru_cache(maxsize=None)
def _index_tables(spec: PatchSpec) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(iy, ix) gather tables [P, Wy*Wx] plus position bits uint8 [P, pos_bits]."""
    spec.validate()
    xs = np.arange(spec.bx) * spec.stride_x
    ys = np.arange(spec.by) * spec.stride_y
    py, px = np.meshgrid(ys, xs, indexing="ij")           # y outer, x inner
    py = py.reshape(-1)
    px = px.reshape(-1)
    wy, wx = np.meshgrid(
        np.arange(spec.window_y), np.arange(spec.window_x), indexing="ij"
    )
    iy = py[:, None] + wy.reshape(-1)[None, :]            # [P, Wy*Wx]
    ix = px[:, None] + wx.reshape(-1)[None, :]

    # Thermometer position code (paper Table I): patch index p sets the
    # lowest p bits of the span.
    def therm(positions: np.ndarray, nbits: int) -> np.ndarray:
        bit = np.arange(nbits)[None, :]
        return (bit < positions[:, None]).astype(np.uint8)

    pos_y = therm(py // spec.stride_y, spec.n_pos_y_bits)
    pos_x = therm(px // spec.stride_x, spec.n_pos_x_bits)
    return iy, ix, np.concatenate([pos_y, pos_x], axis=1)


def extract_patch_features(images: torch.Tensor, spec: PatchSpec) -> torch.Tensor:
    """Booleanized uint8 ``[B, Y, X]`` (Z=U=1) or ``[B, Y, X, Z, U]`` ->
    uint8 ``[B, P, o]`` feature bits in the ASIC's literal order."""
    iy, ix, pos = _index_tables(spec)
    if images.dim() == 3:
        images = images[..., None, None]
    if images.shape[-2:] != (spec.channels, spec.therm_bits):
        raise ValueError(
            f"images trailing dims {tuple(images.shape[-2:])} != "
            f"(Z={spec.channels}, U={spec.therm_bits})"
        )
    b = images.shape[0]
    dev = images.device
    win = images[:, torch.from_numpy(iy).to(dev), torch.from_numpy(ix).to(dev)]
    win = win.reshape(b, spec.n_patches, spec.n_window_features)
    posb = torch.from_numpy(pos).to(dev).expand(b, -1, -1)
    return torch.cat([win.to(torch.uint8), posb], dim=-1)


def make_literals(features: torch.Tensor) -> torch.Tensor:
    """[.., o] feature bits -> [.., 2o] literals = [x, 1 - x] (Eq. 1)."""
    return torch.cat([features, 1 - features], dim=-1).to(torch.uint8)


def pack_bits(bits: torch.Tensor, n_words: int | None = None) -> torch.Tensor:
    """Pack 0/1 bits along the last axis into int32 words, LSB-first.

    ``bits[..., k]`` maps to word ``k // 32`` bit ``k % 32``; trailing pad
    bits are zero.  Words hold the reference's uint32 bit patterns.
    """
    n = bits.shape[-1]
    w = (n + 31) // 32
    if n_words is None:
        n_words = w
    if n_words < w:
        raise ValueError(f"n_words={n_words} too small for {n} bits")
    pad = n_words * 32 - n
    b = bits.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(b.shape[:-1] + (n_words, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (b << shifts).sum(dim=-1)                        # [0, 2^32)
    # Wrap to the int32 bit pattern explicitly (no reliance on how a
    # narrowing cast treats out-of-range values).
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns uint8 0/1 ``[..., n_bits]``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1              # masked arithmetic shift
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return bits[..., :n_bits].to(torch.uint8)
