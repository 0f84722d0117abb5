"""Class-sum kernel: Eq. (3) class sums from fired clause bits.

Replaces the TPU kernel ``src/repro/kernels/class_sum.py:class_sum_pallas``
with the CUDA kernel ``csrc/class_sum.cu`` (its source note gives the bound
and the design).  :func:`class_sum_cuda` launches it;
:func:`class_sum_plain` is the plain PyTorch version
(``core/clauses.py:class_sums``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import clauses as cl
from repro_torch.kernels import _build
from repro_torch.kernels.shapes import as_uint8, check_cuda

__all__ = ["class_sum_cuda", "class_sum_plain"]


def class_sum_plain(fired: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """int32 ``[B, M]`` = fired ``[B, C]`` x int8 weights ``[M, C]``ᵀ."""
    return cl.class_sums(fired, weights)


def _entry():
    """The C entry point, built and loaded on first use."""
    return _build.entry("class_sum", "class_sum",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def class_sum_cuda(fired: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA class-sum kernel on fired 0/1 ``[B, C]`` (uint8 or
    bool, viewed as uint8) and weights ``[M, C]`` (taken as int8), both on
    one CUDA card.  Returns int32 ``[B, M]``."""
    if fired.dim() != 2 or weights.dim() != 2 or weights.shape[1] != fired.shape[1]:
        raise ValueError(
            f"fired must be [B, C] and weights [M, C]; got {list(fired.shape)} "
            f"and {list(weights.shape)}"
        )
    dev = check_cuda("class_sum_cuda", fired, weights)
    b, c = fired.shape
    m = weights.shape[0]
    f8 = as_uint8(fired)
    w8 = weights.to(torch.int8).contiguous()
    if b == 0 or m == 0 or c == 0:
        return torch.zeros((b, m), dtype=torch.int32, device=dev)
    out = torch.empty((b, m), dtype=torch.int32, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(f8.data_ptr(), w8.data_ptr(), out.data_ptr(), b, c, m, stream)
    _build.check("class_sum", code)
    class_sum_cuda.launches += 1
    return out


#: Launches of the CUDA kernel (a plain count; reset by callers).
class_sum_cuda.launches = 0
