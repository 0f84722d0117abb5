"""Port vs ``jax.random``: the threefry2x32 key stream of ``core/prng.py``.

The same seeds go to ``jax.random`` (JAX's defaults: threefry2x32, the
partitionable form) and to the port's copy.  Keys, ``split``,
``random_bits``, ``uniform``, ``bernoulli`` and ``randint`` are equal bit
for bit.  ``gumbel`` and ``normal`` take ``log`` of equal uniforms, and
PyTorch's and XLA's float32 ``log`` round apart in the last place: ``gumbel``
is held within 2 ulp at each of its two logs (:func:`assert_gumbel_close`),
``normal`` within 1e-6.  ``categorical`` is equal wherever its top two
scores lie more than 2 ulp apart.  Batched keys draw as ``jax.vmap`` over
keys does.

PyTorch runs on one CPU thread in these tests (``one_thread``): in a
process that has compiled and run JAX on the CPU, PyTorch's multi-threaded
float kernels were seen to round wrong (``torch.log`` off by ~1,566 ulp on
a third of a tensor's elements, on the first call after a JAX
computation); on one thread they were not.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import ops, registry
from repro_torch.kernels.threefry import fma_f32, threefry_cuda, threefry_plain

SEEDS = [0, 7, 2**31 + 5]
#: Odd sizes, a 0-d shape, no elements, and one sample's Gumbel draw of a
#: full-width TM step ([361, 128]).
SHAPES = [(), (0,), (1,), (7, 5), (3, 0, 2), (1001,), (361, 128)]
TM_STEP = (100, 361, 128)


@pytest.fixture
def one_thread():
    """PyTorch's CPU ops on one thread for the test (see the module note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_thread_module():
    """``one_thread`` for a whole module: for the reason above, and for
    modules of many small operations, where a pool of threads per
    operation costs more than it gives, and far more beside other test
    processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _prng_one_thread(one_thread):
    yield


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def assert_gumbel_close(got, want, u):
    """``got`` and ``want`` are ``-log(-log(u))`` of the same uniforms ``u``
    through two float32 logs, XLA's (within ~1.2 ulp of the true value)
    and PyTorch's (within ~0.55): at each log they may round up to 2 ulp
    apart.  An ulp of the inner log moves the result by ``spacing(t) / t``
    (``t = -log(u)``), one of the outer log by ``spacing(g)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    t = -np.log(np.asarray(u, np.float64))
    inner = np.spacing(t.astype(np.float32)).astype(np.float64) / t
    outer = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= 2 * (inner + outer)).all(), np.abs(got - want).max()


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 5])
def test_prng_key_and_key_data_equal_jax(seed):
    jk, tk = _keys(seed)
    assert tk.dtype == torch.int32 and tk.shape == (2,)
    np.testing.assert_array_equal(prng.key_data(tk), np.asarray(jax.random.key_data(jk)))
    assert torch.equal(prng.key_from_data(np.asarray(jk)), tk)
    assert torch.equal(prng.key_from_data(prng.key_data(tk).tolist()), tk)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 7, (2, 3), 1])
def test_split_equals_jax(seed, num):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(prng.key_data(prng.split(tk, num)),
                                  np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_keys_draw_as_vmap(seed):
    jk, tk = _keys(seed)
    jks = jax.random.split(jk, 6).reshape(2, 3, 2)
    tks = prng.key_from_data(np.asarray(jks))
    np.testing.assert_array_equal(
        prng.key_data(prng.split(tks, 7)),
        np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.split(k, 7)))(jks)))
    flat = jks.reshape(6, 2)
    got = prng.uniform(tks, (4, 5)).reshape(6, 4, 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (4, 5)))(flat)))
    got = prng.randint(tks, (), 0, 9).reshape(6).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, 9))(flat)))
    got = prng.random_bits(tks, (3,)).reshape(6, 3)
    np.testing.assert_array_equal(_bits(got), np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (3,)))(flat)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_randint_equal_jax(seed, shape):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(_bits(prng.random_bits(tk, shape)),
                                  np.asarray(jax.random.bits(jk, shape)))
    got = prng.uniform(tk, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(prng.bernoulli(tk, 0.3, shape).numpy(),
                                  np.asarray(jax.random.bernoulli(jk, 0.3, shape)))
    for lo, hi in ((0, 9), (118, 138), (-2**31, 2**31 - 1), (5, 5)):
        np.testing.assert_array_equal(prng.randint(tk, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(jk, shape, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-3.7, 2.1), (1e-3, 7.0)])
def test_uniform_with_bounds_and_dtypes_equals_jax(seed, dtype, bounds):
    """The float32 path's multiply-add rounds once, as XLA fuses it; the
    bfloat16 path takes 8 random bits and rounds after each operation."""
    jk, tk = _keys(seed)
    got = prng.uniform(tk, (37, 29), getattr(torch, dtype), *bounds)
    want = np.asarray(jax.random.uniform(jk, (37, 29), getattr(jnp, dtype), *bounds))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    assert bool((got >= torch.tensor(bounds[0], dtype=got.dtype)).all())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES[2:], ids=str)
def test_gumbel_within_an_ulp_of_each_log_and_normal_within_1e6(seed, shape):
    jk, tk = _keys(seed)
    u = prng.uniform(tk, shape, minval=np.finfo(np.float32).tiny)
    assert_gumbel_close(prng.gumbel(tk, shape), np.asarray(jax.random.gumbel(jk, shape)), u)
    got, want = prng.normal(tk, shape).numpy(), np.asarray(jax.random.normal(jk, shape))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_a_tm_steps_uniforms_equal_jax():
    """One batch-100 TM step's largest draws: a Type I uniform and the
    Gumbel noise over [100, 361, 128] per-sample keys."""
    jk, tk = _keys(11)
    jks, tks = jax.random.split(jk, TM_STEP[0]), prng.split(tk, TM_STEP[0])
    np.testing.assert_array_equal(prng.key_data(tks), np.asarray(jks))
    got = prng.uniform(tks, TM_STEP[1:])
    want = jax.vmap(lambda k: jax.random.uniform(k, TM_STEP[1:]))(jks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.vmap(lambda k: jax.random.gumbel(k, TM_STEP[1:]))(jks)
    got = prng.gumbel(tks, TM_STEP[1:])
    u = prng.uniform(tks, TM_STEP[1:], minval=np.finfo(np.float32).tiny)
    assert_gumbel_close(got, want, u)


def test_start_draws_a_slice_of_a_larger_draw():
    """``start`` gives the elements of a larger draw from that flat
    position: how a stacked leaf's layers are drawn one at a time."""
    tk = prng.prng_key(4)
    whole = prng.normal(tk, (3, 5, 4))
    assert torch.equal(prng.normal(tk, (5, 4), start=20), whole[1])
    assert torch.equal(prng.random_bits(tk, (7,), start=53),
                       prng.random_bits(tk, (60,))[53:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_equals_jax_where_the_top_two_differ(seed, dtype):
    """Tokens equal wherever the top two Gumbel scores lie more than 2 ulp
    apart (there the logs' last place cannot decide)."""
    jk, tk = _keys(seed)
    logits = np.random.default_rng(seed % 1000).standard_normal((64, 50)).astype(np.float32)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    got = prng.categorical(tk, tl / 0.7, axis=-1).numpy()
    want = np.asarray(jax.random.categorical(jk, jl / 0.7, axis=-1))
    scores = (prng.gumbel(tk, tl.shape, tl.dtype) + tl / 0.7).float().numpy()
    top = np.sort(scores, axis=-1)
    # bfloat16 keeps 16 fewer mantissa bits than float32.
    ulp = np.spacing(np.abs(top[:, -1])) * (1 if dtype == "float32" else 2.0 ** 16)
    clear = top[:, -1] - top[:, -2] > 2 * ulp
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])


def test_keys_are_int32_words_and_bad_keys_raise():
    with pytest.raises(TypeError, match="int32"):
        prng.uniform(torch.zeros(2, dtype=torch.int64), (3,))
    with pytest.raises(TypeError, match="int32"):
        prng.split(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        prng.key_from_data([1, 2, 3])
    with pytest.raises(TypeError, match="float32"):
        prng.normal(prng.prng_key(0), (3,), torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        prng.uniform(prng.prng_key(0), (3,), torch.float16)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.prng_key(0), (3,), 0, 2**31)


def test_plain_threefry_modes_agree_and_the_wrapper_needs_the_card():
    """The three outputs of one hash: bits are the pair's xor, uniforms
    its top 23 bits; on a CPU tensor ``ops.threefry`` takes the plain
    version, and the CUDA wrapper refuses it."""
    keys = prng.key_from_data(np.array([[0, 1], [7, 0xFFFFFFFF], [2**31, 3]], np.uint32))
    pairs = threefry_plain(keys, 300, "pairs", start=2**32 - 7)
    bits = threefry_plain(keys, 300, "bits", start=2**32 - 7)
    assert torch.equal(pairs[..., 0] ^ pairs[..., 1], bits)
    u = threefry_plain(keys, 300, "uniform", start=2**32 - 7)
    want = ((bits >> 9) & 0x7FFFFF | 0x3F800000).view(torch.float32) - 1
    assert torch.equal(u, want)
    assert torch.equal(ops.threefry(keys, 300, "bits", start=2**32 - 7), bits)
    assert threefry_plain(keys, 0, "pairs").shape == (3, 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        threefry_cuda(keys, 4)
    with pytest.raises(ValueError, match="mode"):
        threefry_plain(keys, 4, "normal")
    assert registry.KERNELS["threefry"].plain is threefry_plain


def _fma_exact(a: float, b: float, c: float) -> np.float32:
    """``a * b + c`` rounded once to float32, from the exact rational value
    (nearest of the float32 neighbours of its float64 rounding, ties to
    even)."""
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(np.array(x).view(np.int32)) & 1))


@pytest.mark.parametrize("b,c", [(1.3, -0.7), (3.0, 1.0), (0.1, 2.5e-3), (-5.8, 4.4)])
def test_fma_rounds_once(b, c):
    """``fma_f32`` against the exact product and sum rounded once, on
    uniforms and on inputs built to land on float32 halfway points."""
    a = np.random.default_rng(1).random(2048).astype(np.float32)
    b32, c32 = np.float32(b), np.float32(c)
    got = fma_f32(torch.from_numpy(a.copy()), float(b32), float(c32)).numpy()
    want = np.array([_fma_exact(float(x), float(b32), float(c32)) for x in a], np.float32)
    np.testing.assert_array_equal(got, want)

