"""Images whose pixels sit at or near their adaptive local mean, for the
adaptive booleanize's tests on the CPU and on the card (numpy only: the
card's machine has no JAX)."""

import numpy as np

# (block_size, c) cases that take each branch of the window sum: one lane
# block of 1, 2, 4 or 8 products, a 16-block chained with fused
# multiply-adds, and 3 blocks of 8 (a 16-block and an 8-block summed apart).
ADAPTIVE_CASES = [(3, 0.5), (5, 2.0), (7, 3.0), (11, 2.0), (13, 1.5), (17, 2.0), (25, 4.0),
                  (41, 2.0)]


def near_mean_images(n: int, y: int, x: int, seed: int) -> np.ndarray:
    """``n`` (at least 5) uint8 images ``[n, y, x]``: a smooth ramp, two
    integer planes, a flat image, a product pattern, then random pixels.
    On a plane or a flat image the exact local mean away from the edges is
    the pixel itself, so at ``c = 0`` the mean's last bit decides each such
    pixel."""
    i, j = np.mgrid[0:y, 0:x]
    images = np.random.default_rng(seed).integers(0, 256, (n, y, x), dtype=np.uint8)
    images[0] = (np.linspace(0, 255, y, dtype=np.float32)[:, None]
                 + np.linspace(0, 255, x, dtype=np.float32)[None, :]) / 2
    images[1] = (i + 2 * j) % 256
    images[2] = (200 - 3 * i // 2 - j) % 256
    images[3] = 77
    images[4] = (i * j) % 256
    return images
