"""Threefry2x32-20 kernel: the counter hash behind ``jax.random``'s keys.

The reference draws every random number from ``jax.random``, whose
threefry2x32 primitive XLA lowers to its own code (no Pallas kernel).  The
port reproduces that stream bit for bit (``core/prng.py``), and this
module evaluates its hash: ``K`` keys x ``N`` counters, the counter of
element ``i`` being the 64-bit ``start + i`` as (high word, low word), as
``iota_2x32_shape`` gives it in the partitionable form.  Each (key,
counter) pair hashes to two words ``(b1, b2)``; a launch writes one of

  * ``"bits"``: ``b1 ^ b2`` as int32 ``[K, N]`` (``random_bits``);
  * ``"uniform"``: float32 ``[K, N]`` in ``[minval, maxval)`` by the
    reference's mantissa trick (``_uniform``);
  * ``"pairs"``: ``(b1, b2)`` as int32 ``[K, N, 2]`` (``split``).

:func:`threefry_cuda` launches ``csrc/threefry.cu`` (its source note gives
the bound and the design); :func:`threefry_plain` is the plain PyTorch
version, in int32 in-place operations (words as int32 bit patterns, a
mask after every ``>>``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.shapes import check_cuda

__all__ = ["MODES", "fma_f32", "threefry_cuda", "threefry_plain"]

#: Output kinds, in the C interface's numbering.
MODES = {"bits": 0, "uniform": 1, "pairs": 2}

#: Threefry-2x32's rotation distances, alternating every four rounds.
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: The key schedule's parity constant (Skein's C240, truncated).
PARITY = 0x1BD11BDA
#: Elements (keys x counters) of one block of the plain version on the CPU.
CPU_BLOCK = 32000


def _i32(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _check(keys: torch.Tensor, n: int, mode: str, start: int) -> None:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [K, 2]; got {keys.dtype} {list(keys.shape)}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}; got {mode!r}")
    if n < 0 or start < 0 or start + n > 1 << 64:
        raise ValueError(f"counters [{start}, {start + n}) leave the 64-bit counter space")


def _uniform_span(minval: float, maxval: float):
    """``minval`` and ``maxval - minval`` rounded to float32, as the
    reference converts and subtracts them."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(maxval) - lo)


def fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add, as the
    reference's compiler and the kernel's ``__fmaf_rn`` compute it), for
    float32 ``a`` and float32-exact ``b`` and ``c``; in place on ``a``.

    Where ``a * b`` is exact in float32 (``b`` a power of two, or ``c``
    zero) two float32 operations round the same way.  Otherwise the sum
    is taken in float64, where ``a * b`` is exact, and a float64 result
    that lands on a float32 halfway point without being exact is moved
    one step toward the true value before the final rounding (the fmaf
    of musl libc)."""
    if c == 0.0 or math.frexp(b)[0] == 0.5:
        return a.mul_(b).add_(c)
    xy = a.double().mul_(b)
    r = xy + c
    bits = r.view(torch.int64)
    inexact = ((r - xy) != c) | ((r - c) != xy)
    halfway = (bits & 0x1FFFFFFF) == 0x10000000
    neg = r < 0
    err = torch.where(neg == (xy < c), xy - r + c, c - r + xy)
    step = torch.where(neg == (err < 0), 1, -1)
    bits = torch.where(halfway & inexact, bits + step, bits)
    return a.copy_(bits.view(torch.float64))


def _empty(keys: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    k = keys.shape[0]
    if mode == "pairs":
        return torch.empty((k, n, 2), dtype=torch.int32, device=keys.device)
    dtype = torch.float32 if mode == "uniform" else torch.int32
    return torch.empty((k, n), dtype=dtype, device=keys.device)


def _rotl_(x: torch.Tensor, r: int, tmp: torch.Tensor) -> None:
    """``x`` rotated left by ``r`` bits, in place (``tmp`` is scratch)."""
    torch.bitwise_right_shift(x, 32 - r, out=tmp)
    tmp.bitwise_and_((1 << r) - 1)
    x.bitwise_left_shift_(r)
    x.bitwise_or_(tmp)


def hash_plain(keys: torch.Tensor, n: int, start: int = 0):
    """The two hash words ``(b1, b2)``, int32 ``[K, n]`` each, of every key
    of ``keys [K, 2]`` at counters ``start .. start + n - 1``.  On the CPU
    the counters go in blocks of about :data:`CPU_BLOCK` elements, so each
    of the ~130 passes works in cache on one thread (PyTorch splits an
    operation over threads only past 32,768 elements)."""
    if keys.is_cuda or keys.shape[0] * n <= CPU_BLOCK:
        return _hash_block(keys, n, start)
    step = max(1, CPU_BLOCK // keys.shape[0])
    blocks = [_hash_block(keys, min(step, n - s), start + s) for s in range(0, n, step)]
    return tuple(torch.cat(words, dim=1) for words in zip(*blocks))


def _hash_block(keys: torch.Tensor, n: int, start: int):
    k0 = keys[:, 0:1].clone()
    k1 = keys[:, 1:2].clone()
    k2 = k0 ^ k1 ^ _i32(PARITY)
    ks = (k0, k1, k2)
    count = torch.arange(start, start + n, dtype=torch.int64, device=keys.device)
    x0 = (count >> 32).to(torch.int32).expand(keys.shape[0], n).clone()
    x1 = (count & 0xFFFFFFFF).to(torch.int32).expand(keys.shape[0], n).clone()
    tmp = torch.empty_like(x1)
    x0.add_(k0)
    x1.add_(k1)
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            x0.add_(x1)
            _rotl_(x1, r, tmp)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(group + 1) % 3])
        x1.add_(ks[(group + 2) % 3] + (group + 1))
    return x0, x1


def threefry_plain(keys: torch.Tensor, n: int, mode: str = "bits", *, start: int = 0,
                   minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Threefry2x32-20 of ``keys`` int32 ``[K, 2]`` at counters ``start ..
    start + n - 1``, written as ``mode`` (see the module note), in plain
    PyTorch on the keys' device."""
    _check(keys, n, mode, start)
    if n == 0 or keys.shape[0] == 0:
        return _empty(keys, n, mode)
    b1, b2 = hash_plain(keys, n, start)
    if mode == "pairs":
        return torch.stack((b1, b2), dim=-1)
    b1.bitwise_xor_(b2)
    if mode == "bits":
        return b1
    lo, span = _uniform_span(minval, maxval)
    # 23 random mantissa bits under the exponent of 1.0: [1, 2) -> [0, 1).
    b1.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    f = b1.view(torch.float32).sub_(1.0)
    return fma_f32(f, span, lo).clamp_(min=lo)


def _entry():
    """The C entry point, built and loaded on first use."""
    return _build.entry("threefry", "threefry", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ])


def threefry_cuda(keys: torch.Tensor, n: int, mode: str = "bits", *, start: int = 0,
                  minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Launch the CUDA threefry kernel on ``keys`` int32 ``[K, 2]`` (on one
    CUDA card) for counters ``start .. start + n - 1``; returns the
    ``mode`` output (see the module note) on the keys' card."""
    _check(keys, n, mode, start)
    dev = check_cuda("threefry_cuda", keys)
    out = _empty(keys, n, mode)
    if n == 0 or keys.shape[0] == 0:
        return out
    keys = keys.contiguous()
    lo, span = _uniform_span(minval, maxval)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(keys.data_ptr(), keys.shape[0], n, start, MODES[mode], lo, span,
                  out.data_ptr(), stream)
    _build.check("threefry", code)
    threefry_cuda.launches += 1
    return out


#: Launches of the CUDA kernel (a plain count; reset by callers).
threefry_cuda.launches = 0
