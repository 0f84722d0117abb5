"""Fused clause-eval + class-sum kernel (dense clause pool).

Replaces the TPU kernel ``src/repro/kernels/fused_infer.py:fused_infer_pallas``
with the CUDA kernel ``csrc/fused_infer.cu`` (its source note gives the
bound and the design).  :func:`fused_infer_cuda` launches it;
:func:`fused_infer_plain` is the plain PyTorch version, which walks the
patch axis in chunks so its ``[B, Pc, C, W]`` temporary stays small.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import clauses as cl
from repro_torch.kernels import _build
from repro_torch.kernels.shapes import clamp_block

__all__ = ["fused_infer_cuda", "fused_infer_plain"]

#: Clauses per CUDA block (one tile of the sequential-OR register).
BLOCK_C = 128


def fused_infer_plain(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """int32 ``[B, M]`` class sums in plain PyTorch (int8 weights semantics)."""
    fired = cl.eval_clauses_bitpacked(lit_packed, include_packed, nonempty)
    return cl.class_sums(fired, weights)


@functools.cache
def _entry():
    """The C entry point, built and loaded on first use."""
    fn = _build.library("fused_infer").fused_infer
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(lit_packed, include_packed, nonempty, weights) -> None:
    if lit_packed.dim() != 3 or include_packed.dim() != 2:
        raise ValueError("lit_packed must be [B, P, W] and include_packed [C, W]")
    b, p, w = lit_packed.shape
    c = include_packed.shape[0]
    if include_packed.shape[1] != w:
        raise ValueError(f"word counts differ: literals {w}, include {include_packed.shape[1]}")
    if tuple(nonempty.shape) != (c,) or weights.dim() != 2 or weights.shape[1] != c:
        raise ValueError(
            f"nonempty must be [{c}] and weights [M, {c}]; got "
            f"{list(nonempty.shape)} and {list(weights.shape)}"
        )
    for name, t in (("lit_packed", lit_packed), ("include_packed", include_packed)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must hold int32 words, got {t.dtype}")


def fused_infer_cuda(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    weights: torch.Tensor,
    *,
    csrf: bool = True,
) -> torch.Tensor:
    """Launch the CUDA fused kernel; every operand on one CUDA card.
    Weights are taken as int8 (the servable's clamp), ``nonempty`` as
    0/1.  Returns int32 ``[B, M]``."""
    _check(lit_packed, include_packed, nonempty, weights)
    dev = lit_packed.device
    if not all(t.is_cuda and t.device == dev
               for t in (lit_packed, include_packed, nonempty, weights)):
        raise ValueError("fused_infer_cuda needs every operand on one CUDA device")
    b, p, w = lit_packed.shape
    c = include_packed.shape[0]
    m = weights.shape[0]
    lit = lit_packed.contiguous()
    inc = include_packed.contiguous()
    # bool is one byte of 0/1: view it, no conversion kernel.
    ne = (nonempty.view(torch.uint8) if nonempty.dtype == torch.bool
          else (nonempty != 0).to(torch.uint8)).contiguous()
    w8 = weights.to(torch.int8).contiguous()
    out = torch.zeros((b, m), dtype=torch.int32, device=dev)
    if b == 0 or c == 0 or m == 0:
        return out
    fn = _entry()
    block_c = clamp_block(BLOCK_C, c, 32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            lit.data_ptr(), inc.data_ptr(), ne.data_ptr(), w8.data_ptr(),
            out.data_ptr(), b, p, c, w, m, block_c, int(bool(csrf)), stream,
        )
    _build.check("fused_infer", code)
    fused_infer_cuda.launches += 1
    return out


#: Launches of the CUDA kernel (a plain count; reset by callers).
fused_infer_cuda.launches = 0
