"""Seeded synthetic glyphs, the benchmark's image pool.

A frozen copy of ``repro_torch/data/datasets.py`` ``synthetic_glyphs``
(the images only): ten stroke patterns on a 28x28 canvas, thickness 2-3,
shifted by up to 3 pixels, 2% of pixels flipped, uint8 0 or 255.  Frozen
here so that a change to the program cannot change the benchmark's
inputs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["glyph_pool"]


def _draw_glyph(cls: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    t = int(rng.integers(2, 4))          # stroke thickness
    a, b = 6, 21                          # bounding box

    def hline(y, x0=a, x1=b):
        img[y : y + t, x0:x1] = 1.0

    def vline(x, y0=a, y1=b):
        img[y0:y1, x : x + t] = 1.0

    def diag(sign):
        for i in range(b - a):
            y = a + i
            x = a + i if sign > 0 else b - 1 - i
            img[y : y + t, x : x + t] = 1.0

    if cls == 0:       # box
        hline(a); hline(b - t); vline(a); vline(b - t)
    elif cls == 1:     # vertical bar
        vline(13)
    elif cls == 2:     # horizontal bar
        hline(13)
    elif cls == 3:     # plus
        vline(13); hline(13)
    elif cls == 4:     # main diagonal
        diag(+1)
    elif cls == 5:     # anti-diagonal
        diag(-1)
    elif cls == 6:     # X
        diag(+1); diag(-1)
    elif cls == 7:     # T
        hline(a); vline(13)
    elif cls == 8:     # L
        vline(a); hline(b - t)
    else:              # U
        vline(a); vline(b - t); hline(b - t)
    return img


def glyph_pool(rng: np.random.Generator, n: int, noise: float = 0.02,
               max_shift: int = 3) -> np.ndarray:
    """``n`` glyphs, uint8 ``[n, 28, 28]`` in 0..255, drawn from ``rng``."""
    xs = np.zeros((n, 28, 28), np.uint8)
    ys = rng.integers(0, 10, n)
    for i in range(n):
        g = _draw_glyph(int(ys[i]), rng)
        dy, dx = rng.integers(-max_shift, max_shift + 1, 2)
        g = np.roll(np.roll(g, dy, axis=0), dx, axis=1)
        flip = rng.random((28, 28)) < noise
        g = np.where(flip, 1.0 - g, g)
        xs[i] = (g * 255).astype(np.uint8)
    return xs
