"""Port vs reference: adaptive and thermometer booleanization and every
ingress method.

The same numpy images go through ``repro.core.booleanize`` /
``repro.core.ingress`` and their port counterparts (on the CPU) and the
bits are held with ``array_equal``.  The adaptive method is also pinned
to OpenCV's outputs in ``tests/data/adaptive_golden.npz`` with the same
checks ``tests/test_booleanize_golden.py`` makes of the reference.
"""

import importlib
import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ingress import IngressSpec as JIngressSpec
from repro.core.ingress import apply_ingress as j_apply_ingress
from repro.core.ingress import raw_trailing_shape as j_raw_trailing_shape
from repro.core.patches import PatchSpec as JPatchSpec
from repro.data import pipeline as jpipe
from repro_torch.convert import words_to_uint32
from repro_torch.core import booleanize as tb
from repro_torch.core.ingress import (
    IngressSpec,
    apply_ingress,
    device_ingress,
    raw_trailing_shape,
)
from repro_torch.core.patches import PatchSpec
from repro_torch.data import pipeline as tpipe

# The module, not the ``booleanize`` function that ``repro.core`` exports.
jb = importlib.import_module("repro.core.booleanize")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "adaptive_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _configs(golden):
    return [(int(bs), float(c)) for bs, c in golden["configs"]]


def _adaptive(images, bs, c):
    return tb.adaptive_gaussian_booleanize(torch.from_numpy(images), bs, c).numpy()


@pytest.mark.parametrize("size", [1, 3, 5, 7, 11, 15, 17, 25, 31])
def test_gaussian_kernel_matches_reference(size):
    np.testing.assert_array_equal(tb.gaussian_kernel1d(size), jb.gaussian_kernel1d(size))


# Sizes that take each branch of the window sum: one lane block of 1, 2, 4
# or 8 products, a 16-block chained with fused multiply-adds, and 3 blocks
# of 8 (a 16-block and an 8-block summed apart).
@pytest.mark.parametrize("block_size,c", [(3, 0.5), (5, 2.0), (7, 3.0), (11, 2.0),
                                          (13, 1.5), (17, 2.0), (25, 4.0), (41, 2.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_matches_reference_on_random_images(block_size, c, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    # Smooth ramps put many pixels near their local mean: the last bit decides.
    ramp = np.linspace(0, 255, 28, dtype=np.float32)
    images[0] = (ramp[None, :] + ramp[:, None]) / 2
    want = np.asarray(jb.adaptive_gaussian_booleanize(images, block_size, c))
    np.testing.assert_array_equal(_adaptive(images, block_size, c), want)


def test_adaptive_matches_reference_on_golden_images(golden):
    images = golden["images"]
    for bs, c in _configs(golden):
        want = np.asarray(jb.adaptive_gaussian_booleanize(images, bs, c))
        np.testing.assert_array_equal(_adaptive(images, bs, c), want)


def test_adaptive_batch_shapes_and_float_input():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 3, 12, 9), dtype=np.uint8)
    want = np.asarray(jb.adaptive_gaussian_booleanize(x, 5, 1.0))
    got = _adaptive(x, 5, 1.0)
    assert got.shape == (2, 3, 12, 9) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    xf = rng.random((2, 10, 10)).astype(np.float32) * 255
    np.testing.assert_array_equal(
        _adaptive(xf, 7, 0.3), np.asarray(jb.adaptive_gaussian_booleanize(xf, 7, 0.3)))
    with pytest.raises(ValueError, match="odd"):
        tb.adaptive_gaussian_booleanize(torch.zeros((1, 5, 5)), 4)


def _round_f32(x):
    """The float32 nearest to the rational ``x``, ties to even."""
    r = np.float32(float(x))
    cands = [r, np.nextafter(r, np.float32(-np.inf)), np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.uint32)) & 1))


def test_fma_rounds_once():
    """The 16-tap blocks' multiply-add equals a float32 fused multiply-add:
    the exact ``a * k + acc`` rounded once.  In the first case the exact
    value rounded to float64 lands on a float32 midpoint, where a float64
    sum rounded twice rounds up and the exact value rounds down; the rest
    are random, with a block-17 window's taps as ``k``."""
    a, acc = np.float32(1 + 2.0**-23), np.float32(2.0**29 + 64)
    k = float(np.float32(32 * (1 - 2.0**-23)))
    got = tb._fma(torch.tensor([a]), k, torch.tensor([acc])).numpy()
    assert got[0] == acc == _round_f32(Fraction(float(a)) * Fraction(k) + Fraction(float(acc)))
    rng = np.random.default_rng(5)
    for k in tb.gaussian_kernel1d(17)[:9].tolist():
        a = (rng.normal(size=64) * 2.0 ** rng.integers(-8, 9, 64)).astype(np.float32)
        acc = (rng.normal(size=64) * 2.0 ** rng.integers(-24, 25, 64)).astype(np.float32)
        got = tb._fma(torch.from_numpy(a), k, torch.from_numpy(acc)).numpy()
        want = [_round_f32(Fraction(float(x)) * Fraction(k) + Fraction(float(y)))
                for x, y in zip(a, acc)]
        np.testing.assert_array_equal(got, np.array(want, np.float32))


def _local_mean_reference(img, block_size):
    """The golden test's independent float64 local mean (locates the
    decision boundary; not the code under test)."""
    k = jb.gaussian_kernel1d(block_size).astype(np.float64)
    pad = block_size // 2
    x = np.pad(img.astype(np.float64), ((pad, pad), (0, 0)), mode="edge")
    x = np.apply_along_axis(lambda col: np.convolve(col, k, "valid"), 0, x)
    x = np.pad(x, ((0, 0), (pad, pad)), mode="edge")
    return np.apply_along_axis(lambda row: np.convolve(row, k, "valid"), 1, x)


def test_adaptive_matches_opencv_away_from_the_boundary(golden):
    """Bit-exact with cv2.adaptiveThreshold outside a 3-level band around
    the threshold, and at most 3.5% of pixels per image differ, as the
    reference's golden test asserts of the reference."""
    images = golden["images"]
    for bs, c in _configs(golden):
        refs = golden[f"ref_b{bs}_c{c:g}"]
        got = _adaptive(images, bs, c)
        for img, ref, out in zip(images, refs, got):
            boundary = np.abs(img.astype(np.float64) - (_local_mean_reference(img, bs) - c)) < 3.0
            assert not np.any((ref != out) & ~boundary), (bs, c)
        assert (refs != got).reshape(len(images), -1).mean(axis=1).max() <= 0.035
        flat = [i for i, im in enumerate(images) if im.min() == im.max()]
        assert flat
        for i in flat:
            np.testing.assert_array_equal(got[i], np.ones_like(got[i]))


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_thermometer_matches_reference(levels):
    np.testing.assert_array_equal(tb.thermometer_thresholds(levels),
                                  jb.thermometer_thresholds(levels))
    x = np.random.default_rng(levels).integers(0, 256, (3, 6, 5, 2), dtype=np.uint8)
    x[0, 0, 0] = [0, 255]
    want = np.asarray(jb.thermometer_encode(x, levels))
    got = tb.thermometer_encode(torch.from_numpy(x), levels).numpy()
    assert got.shape == x.shape + (levels,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method,kw", [
    ("threshold", dict(threshold=90)),
    ("adaptive", dict(block_size=7, c=3.0)),
    ("adaptive_gaussian", dict(block_size=11, c=2.0)),
    ("thermometer", dict(levels=1)),
    ("thermometer", dict(levels=4)),
])
def test_booleanize_dispatch_matches_reference(method, kw):
    x = np.random.default_rng(5).integers(0, 256, (4, 14, 14), dtype=np.uint8)
    want = np.asarray(jb.booleanize(jnp.asarray(x), method=method, **kw))
    np.testing.assert_array_equal(tb.booleanize(torch.from_numpy(x), method=method, **kw).numpy(),
                                  want)
    with pytest.raises(ValueError, match="unknown"):
        tb.booleanize(torch.from_numpy(x), method="otsu")


# (patch kwargs, method, spec kwargs, raw trailing dims)
INGRESS_CASES = {
    "threshold": (dict(image_x=12, image_y=12, window_x=4, window_y=4),
                  "threshold", dict(threshold=60), (12, 12)),
    "adaptive": (dict(image_x=12, image_y=12, window_x=4, window_y=4),
                 "adaptive", dict(block_size=5, c=2.0), (12, 12)),
    "adaptive_alias": (dict(image_x=13, image_y=11, window_x=3, window_y=5, stride_x=2,
                            stride_y=2), "adaptive_gaussian", dict(block_size=3, c=1.0),
                       (11, 13)),
    "thermometer": (dict(image_x=8, image_y=8, window_x=3, window_y=3, therm_bits=3),
                    "thermometer", dict(levels=3), (8, 8)),
    "multichannel_threshold": (dict(image_x=8, image_y=8, window_x=3, window_y=3, channels=3),
                               "threshold", {}, (8, 8, 3)),
    "multichannel_adaptive": (dict(image_x=9, image_y=9, window_x=4, window_y=4, channels=2),
                              "adaptive", dict(block_size=3, c=0.0), (9, 9, 2)),
    "multichannel_thermometer": (dict(image_x=7, image_y=7, window_x=3, window_y=3, channels=2,
                                      therm_bits=2), "thermometer", dict(levels=2), (7, 7, 2)),
    "none_thermometer": (dict(image_x=7, image_y=7, window_x=3, window_y=3, therm_bits=2),
                         "none", {}, (7, 7, 2)),
}


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("case", sorted(INGRESS_CASES))
def test_ingress_methods_match_reference(case, packed):
    patch_kw, method, kw, trailing = INGRESS_CASES[case]
    jspec = JIngressSpec(JPatchSpec(**patch_kw), method=method, packed=packed, **kw)
    spec = IngressSpec(PatchSpec(**patch_kw), method=method, packed=packed, **kw)
    assert raw_trailing_shape(spec) == j_raw_trailing_shape(jspec) == trailing
    assert spec.resolved_method == jspec.resolved_method
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256 if method != "none" else 2, (3,) + trailing, dtype=np.uint8)
    want = np.asarray(j_apply_ingress(jspec, jnp.asarray(raw)))
    got = apply_ingress(spec, torch.from_numpy(raw))
    np.testing.assert_array_equal(words_to_uint32(got) if packed else got.numpy(), want)
    assert device_ingress is apply_ingress
    # The host pipeline (the engine's ``ingress='host'`` route) gives the same.
    host = tpipe.preprocess_for_serving(raw, spec.patch, method=method, packed=packed, **kw)
    assert host.dtype == (np.uint32 if packed else np.uint8)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(
        host, jpipe.preprocess_for_serving(raw, jspec.patch, method=method, packed=packed, **kw))


def test_ingress_spec_validation_matches_reference():
    patch = PatchSpec(therm_bits=3)
    with pytest.raises(ValueError, match="therm_bits"):
        IngressSpec(patch, method="thermometer", levels=2)
    with pytest.raises(ValueError, match="therm_bits"):
        JIngressSpec(JPatchSpec(therm_bits=3), method="thermometer", levels=2)
    with pytest.raises(ValueError, match="unknown booleanization method"):
        IngressSpec(patch, method="gaussian")
    assert IngressSpec(patch, method="thermometer", levels=3).resolved_method == "thermometer"
