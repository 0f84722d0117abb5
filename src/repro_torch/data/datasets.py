"""Datasets for the ConvCoTM (a copy of ``repro/data/datasets.py``:
numpy only, so the port imports nothing of the reference package).

Real data: MNIST / FMNIST / KMNIST in IDX format are loaded when present
under ``$REPRO_DATA_DIR`` (default: the ``data/`` directory at the root
of the repository), laid out as
``<name>/{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]``.

Offline fallbacks, used when the files are absent:
  * ``synthetic_glyphs`` — 10 procedurally drawn 28x28 glyph classes with
    random shift/thickness/noise; visually distinct, so a correct ConvCoTM
    implementation must reach high accuracy on it (used by the integration
    tests as the MNIST stand-in).
  * ``noisy_xor_2d`` — the 2-D noisy XOR task from the CTM paper [13] /
    the FPGA accelerator [28]: 4x4 Boolean images where the class is the
    XOR of two diagonal 2x2 sub-pattern indicators, with label noise.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "load_idx",
    "load_mnist_like",
    "synthetic_glyphs",
    "noisy_xor_2d",
    "get_dataset",
]

#: The repository's own data directory, the default of ``$REPRO_DATA_DIR``.
DEFAULT_DATA_DIR = Path(__file__).resolve().parents[3] / "data"


def data_dir() -> str:
    """Where real datasets are looked for: ``$REPRO_DATA_DIR`` when set."""
    return os.environ.get("REPRO_DATA_DIR", str(DEFAULT_DATA_DIR))


def load_idx(path: str) -> np.ndarray:
    """Read an IDX (u)byte file, gzip-transparent."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"bad IDX magic in {path}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(shape)


def _find(name: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(data_dir(), name, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def load_mnist_like(name: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(train_x, train_y, test_x, test_y) uint8, or None if not on disk."""
    paths = [
        _find(name, "train-images-idx3-ubyte"),
        _find(name, "train-labels-idx1-ubyte"),
        _find(name, "t10k-images-idx3-ubyte"),
        _find(name, "t10k-labels-idx1-ubyte"),
    ]
    if any(p is None for p in paths):
        return None
    tx, ty, vx, vy = (load_idx(p) for p in paths)
    return tx, ty, vx, vy


# ---------------------------------------------------------------------------
# Synthetic glyphs: 10 distinct stroke patterns on a 28x28 canvas.
# ---------------------------------------------------------------------------

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


def synthetic_glyphs(
    n_train: int = 2000,
    n_test: int = 500,
    seed: int = 0,
    noise: float = 0.02,
    max_shift: int = 3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Procedural 10-class glyph dataset, uint8 pixel range [0, 255]."""
    rng = np.random.default_rng(seed)

    def make(n):
        xs = np.zeros((n, 28, 28), np.uint8)
        ys = rng.integers(0, 10, n).astype(np.uint8)
        for i in range(n):
            g = _draw_glyph(int(ys[i]), rng)
            dy, dx = rng.integers(-max_shift, max_shift + 1, 2)
            g = np.roll(np.roll(g, dy, axis=0), dx, axis=1)
            flip = rng.random((28, 28)) < noise
            g = np.where(flip, 1.0 - g, g)
            xs[i] = (g * 255).astype(np.uint8)
        return xs, ys

    tx, ty = make(n_train)
    vx, vy = make(n_test)
    return tx, ty, vx, vy


def noisy_xor_2d(
    n_train: int = 4000,
    n_test: int = 1000,
    seed: int = 0,
    label_noise: float = 0.0,
    background_noise: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """2-D noisy XOR ([13] Sec. 6 / the FPGA accelerator [28]).

    4x4 Boolean images, 2 classes: a 2x2 XOR pattern is placed at a random
    location — the diagonal pattern [[1,0],[0,1]] encodes class 1, the
    anti-diagonal [[0,1],[1,0]] class 0 (the two patterns are the XOR-true /
    XOR-false configurations of a 2-bit pair).  Remaining pixels are sparse
    Bernoulli noise; optional training label noise.  Solvable by a ConvCoTM
    with a 2x2 window (the accelerator in [28] reaches 99.9 %).  Images are
    returned as 0/255 uint8 so the standard booleanization applies.
    """
    rng = np.random.default_rng(seed)

    def make(n, noisy):
        x = (rng.random((n, 4, 4)) < background_noise).astype(np.uint8)
        y = rng.integers(0, 2, n).astype(np.uint8)
        pos = rng.integers(0, 3, (n, 2))
        for i in range(n):
            r, c = pos[i]
            if y[i]:
                pat = np.array([[1, 0], [0, 1]], np.uint8)
            else:
                pat = np.array([[0, 1], [1, 0]], np.uint8)
            x[i, r : r + 2, c : c + 2] = pat
        yl = y.copy()
        if noisy and label_noise > 0:
            flip = rng.random(n) < label_noise
            yl = np.where(flip, 1 - yl, yl)
        return x * 255, yl

    tx, ty = make(n_train, True)
    vx, vy = make(n_test, False)
    return tx, ty, vx, vy


def get_dataset(name: str, **kw):
    """Unified entry: 'mnist' | 'fmnist' | 'kmnist' fall back to glyphs."""
    if name in ("mnist", "fmnist", "kmnist"):
        real = load_mnist_like(name)
        if real is not None:
            return real + ("real",)
        return synthetic_glyphs(**kw) + ("synthetic",)
    if name == "glyphs":
        return synthetic_glyphs(**kw) + ("synthetic",)
    if name == "noisy_xor":
        return noisy_xor_2d(**kw) + ("synthetic",)
    raise ValueError(f"unknown dataset {name}")
