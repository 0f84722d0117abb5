"""Port vs reference: patch geometry, literals and bit packing.

Same numpy inputs through ``repro.core.patches`` (JAX) and
``repro_torch.core.patches``; every output is an integer, so the two are
held bit for bit (``array_equal``).  Packed words: the port's int32 bit
patterns viewed as uint32 equal the reference's words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patches as jp
from repro_torch.convert import words_from_uint32, words_to_uint32
from repro_torch.core import patches as tp

# (image_x, image_y, window_x, window_y, stride_x, stride_y)
GEOMETRIES = {
    "paper": (28, 28, 10, 10, 1, 1),
    "noisy_xor": (4, 4, 2, 2, 1, 1),
    "stride2": (12, 12, 4, 4, 2, 2),
    "whole_image": (11, 9, 11, 9, 1, 1),
}


def _specs(name):
    x, y, wx, wy, dx, dy = GEOMETRIES[name]
    kw = dict(image_x=x, image_y=y, window_x=wx, window_y=wy, stride_x=dx, stride_y=dy)
    return jp.PatchSpec(**kw), tp.PatchSpec(**kw)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_index_tables_match_reference(name):
    js, ts = _specs(name)
    for want, got in zip(jp._index_tables(js), tp._index_tables(ts)):
        np.testing.assert_array_equal(want, got)
    assert (ts.n_patches, ts.n_features, ts.n_words) == (js.n_patches, js.n_features, js.n_words)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_features_literals_and_packing_match_reference(name):
    js, ts = _specs(name)
    rng = np.random.default_rng(11)
    imgs = (rng.random((3, ts.image_y, ts.image_x)) > 0.5).astype(np.uint8)
    want = jp.extract_patch_features(jnp.asarray(imgs), js)
    got = tp.extract_patch_features(torch.from_numpy(imgs), ts)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    want_l, got_l = jp.make_literals(want), tp.make_literals(got)
    np.testing.assert_array_equal(np.asarray(want_l), got_l.numpy())
    np.testing.assert_array_equal(
        np.asarray(jp.pack_bits(want_l, js.n_words)),
        words_to_uint32(tp.pack_bits(got_l, ts.n_words)),
    )


def test_five_dim_features_match_reference():
    kw = dict(image_x=6, image_y=6, window_x=3, window_y=3, channels=2, therm_bits=2)
    js, ts = jp.PatchSpec(**kw), tp.PatchSpec(**kw)
    imgs = (np.random.default_rng(2).random((2, 6, 6, 2, 2)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(jp.extract_patch_features(jnp.asarray(imgs), js)),
        tp.extract_patch_features(torch.from_numpy(imgs), ts).numpy(),
    )


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 272, 8192])
def test_pack_unpack_round_trip(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = torch.from_numpy((rng.random((4, n_bits)) > 0.5).astype(np.uint8))
    words = tp.pack_bits(bits)
    assert words.dtype == torch.int32 and words.shape == (4, (n_bits + 31) // 32)
    torch.testing.assert_close(tp.unpack_bits(words, n_bits), bits, rtol=0, atol=0)
    np.testing.assert_array_equal(
        words_to_uint32(words), np.asarray(jp.pack_bits(jnp.asarray(bits.numpy())))
    )


def test_sign_bit_words_and_conversion():
    """Bit 31 set: the int32 pattern is negative and unpacks with a masked
    shift; the uint32 view carries the same bits both ways."""
    bits = torch.zeros((1, 32), dtype=torch.uint8)
    bits[0, 31] = 1
    words = tp.pack_bits(bits)
    assert words.item() == -(2**31)
    assert tp.unpack_bits(words, 32).tolist() == bits.tolist()
    u = words_to_uint32(words)
    assert u.tolist() == [[0x80000000]]
    assert torch.equal(words_from_uint32(u), words)


def test_pack_bits_rejects_too_few_words():
    with pytest.raises(ValueError, match="too small"):
        tp.pack_bits(torch.ones((2, 40), dtype=torch.uint8), n_words=1)


def test_spec_validation():
    with pytest.raises(ValueError, match="tile"):
        tp._index_tables(tp.PatchSpec(image_x=10, image_y=10, window_x=4, window_y=4,
                                      stride_x=4, stride_y=4))
