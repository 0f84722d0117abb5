"""The plain reference of the ConvCoTM classify step (arXiv:2501.19347).

Worked out again from the raw images and the TA state, with nothing the
program derived: booleanize, patches, literals, clause outputs, class
sums, argmax (paper Sec. III, Algorithm 1, Eqs. 1-5).  NumPy for the
booleanize and the class sums, plain ``torch`` for the clause outputs
(violation counts as float32 matrix products, exact for 0/1 operands);
it imports nothing of the program.

  * Booleanize: threshold (pixel > t), or the adaptive Gaussian
    threshold (pixel > local mean - c; OpenCV's ``adaptiveThreshold``
    with a Gaussian window and replicated edges).  The local mean is
    float32 and a pixel near ``mean - c`` is decided by its last bit, so
    it is summed in the order in which the JAX reference's
    ``jnp.convolve`` sums its window on the CPU (blocks of 8, 4, 2 and 1
    taps; see :func:`_window_sum`), each product and addition rounded to
    float32.
  * Patches: a ``Wy x Wx`` window at strides ``(dy, dx)``, x fastest.
    Features per patch: the window's pixels row by row, then the
    y-position and x-position thermometers (bit j set iff j < the
    patch's position index); literals are ``[features, 1 - features]``
    (paper Table I).
  * A clause fires on a patch iff no included literal is 0, for the image
    iff it fires on some patch and includes at least one literal.
    Include iff the TA state >= 128 (8-bit automata).  Class sums are the
    int8 weights times the clause outputs, the prediction the lowest
    index of the largest sum.

:func:`word_tests` counts the 32-bit word tests a patch-serial clause
test needs (one test per word of 32 literals of one (patch, clause)
pair, stopping at the first violated word and at the first patch that
fires), the yardstick of the kernels' operation floor.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TA_INCLUDE",
    "booleanize",
    "classify",
    "feature_table",
    "gaussian_kernel",
    "int4_weights",
    "literals",
    "n_patches",
    "n_words",
]

#: Include iff the 8-bit TA state is in the upper half.
TA_INCLUDE = 128
#: Images per block of the clause evaluation on the device.
BLOCK = 64


def gaussian_kernel(size: int) -> np.ndarray:
    """The normalised 1-D Gaussian of ``size`` taps at OpenCV's default
    sigma, 0.3 * ((size - 1) / 2 - 1) + 0.8; computed in float64, float32."""
    sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _window_sum(xp: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """``sum_j xp[i + j] * k[j]`` along ``axis`` at the valid positions,
    float32, in the JAX reference's order: one block of 8 taps
    (``((t0 + t1) + (t4 + t5)) + ((t2 + t3) + (t6 + t7))``), then one each
    of 4 (``(t0 + t1) + (t2 + t3)``), 2 and 1 as they fit, each block's sum
    added to the running total in that order.  Windows of 16 taps or more
    chain fused multiply-adds there, which this reference does not
    compute: it refuses them."""
    size = len(k)
    if size >= 16:
        raise ValueError(f"window of {size} taps: the reference sums windows up to 15")
    n = xp.shape[axis] - size + 1

    def tap(j):
        return np.take(xp, np.arange(j, j + n), axis=axis) * k[j]

    total = None
    j = 0
    for width in (8, 4, 2, 1):
        if size - j < width:
            continue
        t = [tap(j + i) for i in range(width)]
        if width == 8:
            part = ((t[0] + t[1]) + (t[4] + t[5])) + ((t[2] + t[3]) + (t[6] + t[7]))
        elif width == 4:
            part = (t[0] + t[1]) + (t[2] + t[3])
        elif width == 2:
            part = t[0] + t[1]
        else:
            part = t[0]
        total = part if total is None else total + part
        j += width
    return total


def _adaptive(images: np.ndarray, block_size: int, c: float) -> np.ndarray:
    if block_size % 2 != 1:
        raise ValueError(f"block_size must be odd, got {block_size}")
    x = images.astype(np.float32)
    k = gaussian_kernel(block_size)
    pad = block_size // 2
    rows = _window_sum(np.pad(x, ((0, 0), (pad, pad), (0, 0)), mode="edge"), k, 1)
    mean = _window_sum(np.pad(rows, ((0, 0), (0, 0), (pad, pad)), mode="edge"), k, 2)
    return (x > (mean - np.float32(c))).astype(np.uint8)


def booleanize(images: np.ndarray, spec: Dict) -> np.ndarray:
    """uint8 ``[N, Y, X]`` pixels -> uint8 0/1 bits by the configuration's
    ``booleanize`` entry (``method`` 'threshold' with ``threshold``, or
    'adaptive' with ``block_size`` and ``c``)."""
    images = np.asarray(images, np.uint8)
    if spec["method"] == "threshold":
        return (images > spec["threshold"]).astype(np.uint8)
    if spec["method"] == "adaptive":
        return _adaptive(images, spec["block_size"], spec["c"])
    raise ValueError(f"unknown booleanize method {spec['method']!r}")


def _geometry(cfg: Dict) -> Tuple[int, int, int, int, int, int]:
    return (cfg["image_y"], cfg["image_x"], cfg["window_y"], cfg["window_x"],
            cfg["stride_y"], cfg["stride_x"])


def n_patches(cfg: Dict) -> int:
    y, x, wy, wx, sy, sx = _geometry(cfg)
    return (1 + (y - wy) // sy) * (1 + (x - wx) // sx)


@functools.lru_cache(maxsize=8)
def _feature_table(geometry: Tuple[int, ...]) -> np.ndarray:
    y, x, wy, wx, sy, sx = geometry
    by, bx = 1 + (y - wy) // sy, 1 + (x - wx) // sx
    zero, one = y * x, y * x + 1                 # constant columns after the pixels
    rows = []
    for py in range(by):
        for px in range(bx):
            win = [(py * sy + i) * x + (px * sx + j) for i in range(wy) for j in range(wx)]
            therm_y = [one if b < py else zero for b in range(y - wy)]
            therm_x = [one if b < px else zero for b in range(x - wx)]
            rows.append(win + therm_y + therm_x)
    table = np.asarray(rows, np.int64)
    table.setflags(write=False)
    return table


def feature_table(cfg: Dict) -> np.ndarray:
    """int64 ``[P, o]``: for each patch and feature, the pixel index
    ``y * X + x`` it reads, or ``Y * X`` (a constant 0) or ``Y * X + 1``
    (a constant 1) for the position thermometers."""
    return _feature_table(_geometry(cfg))


def n_words(cfg: Dict) -> int:
    return (2 * feature_table(cfg).shape[1] + 31) // 32


def literals(bits: np.ndarray, cfg: Dict) -> np.ndarray:
    """uint8 0/1 ``[N, P, 2o]`` literals of booleanized ``[N, Y, X]`` bits."""
    n = bits.shape[0]
    ext = np.concatenate([bits.reshape(n, -1).astype(np.uint8),
                          np.zeros((n, 1), np.uint8), np.ones((n, 1), np.uint8)], axis=1)
    feats = ext[:, feature_table(cfg)]
    return np.concatenate([feats, 1 - feats], axis=-1)


def int4_weights(weights: np.ndarray) -> np.ndarray:
    """The control's weights: int8 weights quantized to int4 (a scale of
    16, rounded, clamped to [-8, 7]) and scaled back."""
    return np.clip(np.round(np.asarray(weights) / 16.0), -8, 7).astype(np.int64) * 16


def _bf16_adaptive(images: np.ndarray, block_size: int, c: float) -> np.ndarray:
    """The control's booleanize: the adaptive threshold with the local
    mean computed in bfloat16, taps in order."""
    x = torch.from_numpy(np.asarray(images)).to(torch.bfloat16)
    k = torch.from_numpy(gaussian_kernel(block_size)).to(torch.bfloat16)
    pad = block_size // 2

    def wsum(v, axis):
        first = v.narrow(axis, 0, 1).repeat_interleave(pad, axis)
        last = v.narrow(axis, v.shape[axis] - 1, 1).repeat_interleave(pad, axis)
        vp = torch.cat([first, v, last], dim=axis)
        n = v.shape[axis]
        acc = vp.narrow(axis, 0, n) * k[0]
        for j in range(1, block_size):
            acc = acc + vp.narrow(axis, j, n) * k[j]
        return acc

    mean = wsum(wsum(x, 1), 2)
    return (x > (mean - torch.tensor(c, dtype=torch.bfloat16))).to(torch.uint8).numpy()


def classify(images: np.ndarray, cfg: Dict, ta_state: np.ndarray, weights: np.ndarray, *,
             device="cpu", want_word_tests: bool = False, control: Optional[str] = None):
    """Class sums int64 ``[N, M]``, predictions int64 ``[N]`` and, with
    ``want_word_tests``, word tests int64 ``[N]`` for raw uint8 ``images``
    ``[N, Y, X]``, TA states uint8 ``[C, 2o]`` and weights ``[M, C]``.

    ``control`` computes the lower-precision control in the program's
    place instead: ``'int4'`` (weights quantized to int4) or ``'bf16'``
    (the adaptive local mean in bfloat16).  The clause outputs run on
    ``device`` in blocks of :data:`BLOCK` images."""
    spec = cfg["booleanize"]
    if control == "bf16":
        if spec["method"] != "adaptive":
            raise ValueError("the bf16 control applies to the adaptive booleanize")
        bits = _bf16_adaptive(images, spec["block_size"], spec["c"])
    elif control in (None, "int4"):
        bits = booleanize(images, spec)
    else:
        raise ValueError(f"unknown control {control!r}")
    w = np.clip(np.asarray(weights, np.int64), -127, 127)
    if control == "int4":
        w = int4_weights(w)
    include = (np.asarray(ta_state) >= TA_INCLUDE)
    nonempty = include.any(axis=1)
    n_lit = include.shape[1]
    nw = (n_lit + 31) // 32
    dev = torch.device(device)
    allow = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        inc = torch.zeros((include.shape[0], nw * 32), dtype=torch.float32, device=dev)
        inc[:, :n_lit] = torch.from_numpy(include.astype(np.float32)).to(dev)
        inc = inc.view(include.shape[0], nw, 32)
        ne = torch.from_numpy(nonempty).to(dev)
        fired = np.zeros((len(images), include.shape[0]), bool)
        tests = np.zeros(len(images), np.int64) if want_word_tests else None
        for i0 in range(0, len(images), BLOCK):
            lit = torch.from_numpy(literals(bits[i0 : i0 + BLOCK], cfg)).to(dev)
            neg = torch.zeros(lit.shape[:2] + (nw * 32,), dtype=torch.float32, device=dev)
            neg[..., :n_lit] = 1 - lit.to(torch.float32)
            # Violations per (image, patch, clause, word): included literals that are 0.
            viol = torch.einsum("npwk,cwk->npcw", neg.view(lit.shape[:2] + (nw, 32)), inc) > 0
            anyv = viol.any(dim=-1)                               # [n, P, C]
            fires = ~anyv
            fired[i0 : i0 + BLOCK] = (fires.any(dim=1) & ne[None]).cpu().numpy()
            if want_word_tests:
                words = torch.where(anyv, viol.to(torch.int8).argmax(dim=-1) + 1, nw)
                p = fires.shape[1]
                idx = torch.arange(p, device=dev)[None, :, None]
                first = torch.where(fires, idx, p).amin(dim=1, keepdim=True)   # [n, 1, C]
                counted = (idx <= first) & ne[None, None]
                tests[i0 : i0 + BLOCK] = (words * counted).sum(dim=(1, 2)).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow
    sums = fired.astype(np.int64) @ w.T
    preds = np.argmax(sums, axis=1)             # first index of the largest sum
    return sums, preds, tests
