"""Port vs reference: adaptive and thermometer booleanization and every
ingress method.

The same numpy images go through ``repro.core.booleanize`` /
``repro.core.ingress`` and their port counterparts (on the CPU) and the
bits are held with ``array_equal``.  The adaptive method is also pinned
to OpenCV's outputs in ``tests/data/adaptive_golden.npz`` with the same
checks ``tests/test_booleanize_golden.py`` makes of the reference.
"""

import contextlib
import importlib
import os
from fractions import Fraction
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _near_mean import ADAPTIVE_CASES, near_mean_images

from repro.core.ingress import IngressSpec as JIngressSpec
from repro.core.ingress import apply_ingress as j_apply_ingress
from repro.core.ingress import raw_trailing_shape as j_raw_trailing_shape
from repro.core.patches import PatchSpec as JPatchSpec
from repro.data import pipeline as jpipe
from repro_torch.convert import words_to_uint32
from repro_torch.core import booleanize as tb
from repro_torch.core import ingress as t_ingress
from repro_torch.core.ingress import (
    IngressSpec,
    apply_ingress,
    device_ingress,
    raw_trailing_shape,
    uses_adaptive_kernel,
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


@pytest.mark.parametrize("block_size,c", ADAPTIVE_CASES)
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


def _kernel_window_sum(v, k, axis):
    """Model of ``csrc/ingress_pack.cu``'s ``AdaptiveGaussian::window_sum``
    at every position of ``axis`` at once: tap j of position i reads ``v``
    at the clamped index ``clamp(i - taps // 2 + j)`` (no padded copy);
    the first ``taps // 16 * 16`` taps go to 8 lanes (products, then one
    fused multiply-add a tap per lane), then blocks of 8, 4, 2 and 1, each
    product and sum a float32 op of its own, in the kernel's order."""
    n, taps = v.shape[axis], len(k)
    first = torch.arange(n) - taps // 2
    kk = [float(t) for t in k]

    def at(j):
        return v.index_select(axis, (first + j).clamp(0, n - 1))

    def prod(j):
        return at(j) * kk[j]

    def reduce8(p):
        return ((p[0] + p[1]) + (p[4] + p[5])) + ((p[2] + p[3]) + (p[6] + p[7]))

    parts = []
    n16 = taps // 16 * 16
    if n16:
        lane = [prod(i) for i in range(8)]
        for j in range(8, n16, 8):
            lane = [tb._fma(at(j + i), kk[j + i], lane[i]) for i in range(8)]
        parts.append(reduce8(lane))
    j = n16
    if taps - j >= 8:
        parts.append(reduce8([prod(j + i) for i in range(8)]))
        j += 8
    if taps - j >= 4:
        parts.append((prod(j) + prod(j + 1)) + (prod(j + 2) + prod(j + 3)))
        j += 4
    if taps - j >= 2:
        parts.append(prod(j) + prod(j + 1))
        j += 2
    if taps - j >= 1:
        parts.append(prod(j))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _kernel_model(images, block_size, c):
    """The adaptive mode of the ingress-pack kernel up to its ballot: raw
    pixels to float32, the Y pass, the X pass on its result, then
    ``pixel > mean - c`` in float32."""
    x = torch.from_numpy(images).to(torch.float32)
    k = tb.gaussian_kernel1d(block_size)
    mean = _kernel_window_sum(_kernel_window_sum(x, k, 1), k, 2)
    return (x > mean - torch.tensor(c, dtype=torch.float32)).to(torch.uint8).numpy()


# Image heights and widths of the kernels' geometries (tests/test_torch_kernels.py
# and chip_smoke.py): the paper's, ``wide``, ``chunked`` and an 11x11 image.
MODEL_IMAGES = {"paper": (28, 28), "wide": (20, 48), "chunked": (64, 64), "11x11": (11, 11),
                "golden": None}


@pytest.mark.parametrize("block_size,c", ADAPTIVE_CASES)
@pytest.mark.parametrize("images", sorted(MODEL_IMAGES))
def test_adaptive_kernel_model_matches_reference(images, block_size, c, golden):
    """The kernel's arithmetic, modelled on the CPU, gives the reference's
    bits bit for bit: clamped indices in place of padding, a fixed order a
    pixel, fused multiply-adds in the 16-blocks.  At ``c = 0`` the planes
    and the flat image are decided by the mean's last bit (a sum taken in
    another order, or a multiply-add rounded twice, fails there)."""
    shape = MODEL_IMAGES[images]
    imgs = golden["images"] if shape is None else near_mean_images(7, *shape, seed=block_size)
    for cc in (c, 0.0):
        want = np.asarray(jb.adaptive_gaussian_booleanize(imgs, block_size, cc))
        np.testing.assert_array_equal(_kernel_model(imgs, block_size, cc), want)


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


PAPER = dict(image_x=28, image_y=28, window_x=10, window_y=10)


# (patch kwargs, spec kwargs, input device, input dtype, takes the kernel)
ROUTES = {
    "card_uint8_adaptive": (PAPER, dict(method="adaptive"), True, torch.uint8, True),
    "card_uint8_alias": (PAPER, dict(method="adaptive_gaussian", block_size=41, c=0.5), True,
                         torch.uint8, True),
    "cpu": (PAPER, dict(method="adaptive"), False, torch.uint8, False),
    "float_pixels": (PAPER, dict(method="adaptive"), True, torch.float32, False),
    "dense": (PAPER, dict(method="adaptive", packed=False), True, torch.uint8, False),
    "threshold": (PAPER, dict(method="threshold"), True, torch.uint8, False),
    "none": (PAPER, dict(method="none"), True, torch.uint8, False),
    "thermometer": (dict(PAPER, therm_bits=3), dict(method="thermometer", levels=3), True,
                    torch.uint8, False),
    "multichannel": (dict(PAPER, channels=2), dict(method="adaptive"), True, torch.uint8,
                     False),
    "window_past_the_taps": (PAPER, dict(method="adaptive", block_size=65), True, torch.uint8,
                             False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_only_raw_uint8_adaptive_packed_card_input_takes_the_adaptive_kernel(case):
    """The route rests on what the input shows: a CUDA uint8 tensor (a
    stand-in here), the adaptive method, the packed form of a Z=U=1
    geometry and a window the launch holds; anything else booleanizes
    first."""
    patch_kw, kw, is_cuda, dtype, fused = ROUTES[case]
    spec = IngressSpec(PatchSpec(**patch_kw), **kw)
    assert uses_adaptive_kernel(spec, SimpleNamespace(is_cuda=is_cuda, dtype=dtype)) is fused


@pytest.mark.parametrize("fused", [False, True], ids=["booleanize_first", "adaptive_kernel"])
def test_adaptive_route_gives_the_references_words_in_one_pack_span(monkeypatch, fused):
    """With the route taken (the predicate forced on, the CPU running the
    kernel's plain twin) one ``ingress.pack`` span covers the whole
    ingress; without it the booleanize has its own span.  The words are
    the reference's either way."""
    spans, calls = [], []

    @contextlib.contextmanager
    def record(name, **_):
        spans.append(name)
        yield

    adaptive = t_ingress.ingress_pack_adaptive
    monkeypatch.setattr(t_ingress, "span", record)
    monkeypatch.setattr(t_ingress, "uses_adaptive_kernel", lambda spec, raw: fused)
    monkeypatch.setattr(t_ingress, "ingress_pack_adaptive",
                        lambda *a: calls.append(a[2:]) or adaptive(*a))
    kw = dict(image_x=12, image_y=12, window_x=4, window_y=4)
    raw = np.random.default_rng(8).integers(0, 256, (3, 12, 12), dtype=np.uint8)
    spec = IngressSpec(PatchSpec(**kw), method="adaptive", block_size=5, c=2.0)
    want = j_apply_ingress(JIngressSpec(JPatchSpec(**kw), method="adaptive", block_size=5,
                                        c=2.0), jnp.asarray(raw))
    got = apply_ingress(spec, torch.from_numpy(raw))
    np.testing.assert_array_equal(words_to_uint32(got), np.asarray(want))
    assert spans == (["ingress.pack"] if fused else ["ingress.booleanize", "ingress.pack"])
    assert calls == ([(5, 2.0)] if fused else [])
