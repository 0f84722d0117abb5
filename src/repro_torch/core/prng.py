"""``jax.random``'s threefry2x32 keys, in PyTorch: the port's random numbers.

The reference draws every random number from ``jax.random`` keys (the
threefry2x32 generator, partitionable form, JAX's defaults).  This module
is the port's copy of the part of ``jax.random`` the reference calls, so
that from one seed both packages draw the same numbers:

  * a **key** is an int32 tensor ``[..., 2]`` holding the two uint32 words
    of ``jax.random.key_data`` as bit patterns; leading dimensions are a
    batch of keys, and every sampler draws for each key of the batch, as
    ``jax.vmap`` over keys does (outputs ``[*key_dims, *shape]``);
  * :func:`prng_key` is ``jax.random.PRNGKey``; :func:`key_data` and
    :func:`key_from_data` carry a key to and from the reference's
    ``uint32[..., 2]`` (checkpoints, ``convert``);
  * :func:`split`, :func:`random_bits`, :func:`uniform`, :func:`bernoulli`
    and :func:`randint` give ``jax.random``'s numbers bit for bit;
  * :func:`gumbel` and :func:`categorical` take ``log`` of those uniforms,
    and :func:`normal` the inverse error function: PyTorch's ``log`` and
    XLA's round differently in the last place, so these agree with
    ``jax.random`` within an ulp or so (``erf_inv`` is XLA's float32
    polynomial, written out in PyTorch operations).

The counter hash runs in ``csrc/threefry.cu`` for keys on the card and in
its plain PyTorch version for keys on the CPU (``kernels/ops.threefry``);
there is no fallback between them.  Every draw is made on its key's
device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.threefry import CPU_BLOCK

__all__ = [
    "bernoulli",
    "categorical",
    "gumbel",
    "key_data",
    "key_from_data",
    "normal",
    "prng_key",
    "randint",
    "random_bits",
    "split",
    "uniform",
]

Shape = Union[int, Sequence[int]]

#: XLA's float32 ``ErfInv`` (M. Giles' approximation): coefficients for
#: ``w = -log1p(-x * x) < 5`` and for ``w >= 5``, highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _check_key(key: torch.Tensor) -> None:
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int32 or key.dim() < 1 \
            or key.shape[-1] != 2:
        raise TypeError(f"a key is an int32 tensor [..., 2]; got {key!r:.80}")


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(0, seed mod 2**32)``, as
    JAX's default 32-bit mode makes them, int32 ``[2]`` on ``device``."""
    lo = int(seed) & 0xFFFFFFFF
    return key_from_data(np.array([0, lo], dtype=np.uint32), device)


def key_data(key: torch.Tensor) -> np.ndarray:
    """The key's words as the reference holds them: numpy uint32 ``[..., 2]``."""
    _check_key(key)
    return key.detach().cpu().numpy().view(np.uint32)


def key_from_data(data, device=None) -> torch.Tensor:
    """A key from the reference's ``uint32[..., 2]`` words (a list, an array
    or ``jax.random.key_data``'s output), on ``device``."""
    arr = np.ascontiguousarray(np.asarray(data, dtype=np.uint32))
    if arr.ndim < 1 or arr.shape[-1] != 2:
        raise ValueError(f"key data must be uint32 [..., 2]; got shape {arr.shape}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device or "cpu")


def _hash(key: torch.Tensor, shape: Tuple[int, ...], mode: str, *, start: int = 0,
          **kw) -> torch.Tensor:
    """The threefry hash of every key at the flat counters of ``shape``,
    as ``[*key_dims, *shape]`` (``mode`` of ``kernels.threefry``)."""
    _check_key(key)
    dims = tuple(key.shape[:-1])
    out = ops.threefry(key.reshape(-1, 2), math.prod(shape), mode, start=start, **kw)
    return out.reshape(dims + shape + tuple(out.shape[2:]))


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys per key, ``[*key_dims, *num, 2]``."""
    return _hash(key, _shape(num), "pairs")


def random_bits(key: torch.Tensor, shape: Shape = (), *, start: int = 0) -> torch.Tensor:
    """``jax.random.bits`` (32 bits) as int32 bit patterns; ``start`` draws
    the elements ``start ..`` of a larger draw's flat order."""
    return _hash(key, _shape(shape), "bits", start=start)


def uniform(key: torch.Tensor, shape: Shape = (), dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0, *, start: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in ``[minval, maxval)``, float32 or bfloat16,
    with the reference's mantissa trick (8 random bits for bfloat16),
    rounded where its compiler rounds: float32 once after the multiply-add,
    bfloat16 after each operation."""
    shape = _shape(shape)
    if dtype == torch.float32:
        return _hash(key, shape, "uniform", start=start, minval=minval, maxval=maxval)
    if dtype != torch.bfloat16:
        raise TypeError(f"uniform draws float32 or bfloat16; got {dtype}")
    # The low 8 bits, 7 of them under the exponent of 1.0: [1, 2) -> [0, 1).
    bits = random_bits(key, shape, start=start) & 0xFF
    f = ((bits >> 1) | 0x3F80).to(torch.int16).view(dtype) - 1
    lo = torch.tensor(minval, dtype=dtype, device=f.device)
    hi = torch.tensor(maxval, dtype=dtype, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape, dtype of p) < p``
    (a Python float is float32), bool."""
    dtype = p.dtype if isinstance(p, torch.Tensor) else torch.float32
    return uniform(key, shape, dtype) < p


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` of int32 in ``[minval, maxval)``: two 32-bit
    draws from ``split(key)`` folded by the span, in uint32 arithmetic."""
    lo, hi = int(minval), int(maxval)
    i32 = np.iinfo(np.int32)
    if not (i32.min <= lo <= i32.max and i32.min <= hi <= i32.max):
        raise ValueError(f"randint bounds [{lo}, {hi}) leave int32")
    span = 1 if hi <= lo else hi - lo
    m32 = 0xFFFFFFFF
    mult = (1 << 16) % span
    mult = (mult * mult & m32) % span
    bits = random_bits(split(key), shape).to(torch.int64) & m32     # [..., 2, *shape]
    higher, lower = bits.select(key.dim() - 1, 0), bits.select(key.dim() - 1, 1)
    offset = ((higher % span) * mult & m32) + lower % span
    offset = (offset & m32) % span
    return (lo + offset).to(torch.int32)


def _by_blocks(draw, key: torch.Tensor, shape: Tuple[int, ...], start: int = 0) -> torch.Tensor:
    """``draw(key, n, start)`` (``[*key_dims, n]`` over the flat counters
    ``start ..``) for the elements of ``shape``.  On the CPU in blocks of
    about ``CPU_BLOCK`` elements, as the plain hash goes: every operation
    of an elementwise chain then stays in cache on one thread, where a
    whole-tensor chain would split each of its operations over threads.
    Elementwise, so the blocks give the whole draw's values."""
    _check_key(key)
    n, k = math.prod(shape), math.prod(key.shape[:-1])
    if key.is_cuda or k * n <= CPU_BLOCK:
        out = draw(key, n, start)
    else:
        step = max(1, CPU_BLOCK // k)
        out = torch.cat([draw(key, min(step, n - s), start + s) for s in range(0, n, step)],
                        dim=-1)
    return out.reshape(tuple(key.shape[:-1]) + shape)


def gumbel(key: torch.Tensor, shape: Shape = (), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` for ``u``
    uniform in ``[tiny, 1)``."""
    tiny = torch.finfo(dtype).tiny

    def draw(k, n, start):
        return -torch.log(-torch.log(uniform(k, n, dtype, tiny, 1.0, start=start)))

    return _by_blocks(draw, key, _shape(shape))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` in PyTorch operations."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(a, dtype=x.dtype, device=x.device),
                        torch.tensor(b, dtype=x.dtype, device=x.device))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape = (), dtype=torch.float32, *,
           start: int = 0) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` for ``u``
    uniform in ``(-1, 1)``; ``start`` draws the elements ``start ..`` of a
    larger draw's flat order."""
    if dtype != torch.float32:
        raise TypeError(f"normal draws float32; got {dtype}")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    sqrt2 = float(np.float32(np.sqrt(2)))

    def draw(k, n, first):
        return sqrt2 * _erf_inv(uniform(k, n, torch.float32, lo, 1.0, start=first))

    return _by_blocks(draw, key, _shape(shape), start)


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical``: the argmax along ``axis`` of ``logits``
    plus Gumbel noise of their shape and dtype (the first maximum), int64."""
    return torch.argmax(gumbel(key, tuple(logits.shape), logits.dtype) + logits, dim=axis)
