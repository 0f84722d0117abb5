"""Fused clause-eval + class-sum kernels: the dense and the active clause pool.

Replaces the TPU kernels ``src/repro/kernels/fused_infer.py``:
``fused_infer_pallas`` and ``fused_infer_sparse_pallas``, with the two
instantiations of the CUDA kernel ``csrc/fused_infer.cu`` (its source note
gives the bound and the design).  :func:`fused_infer_cuda` and
:func:`fused_infer_sparse_cuda` launch them; :func:`fused_infer_plain` and
:func:`fused_infer_sparse_plain` are the plain PyTorch versions, which walk
the patch axis in chunks so their ``[B, Pc, C, W]`` temporary stays small.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import clauses as cl
from repro_torch.kernels import _build
from repro_torch.kernels.shapes import (
    BLOCK_C,
    as_uint8,
    check_block_c,
    check_cuda,
    check_words,
    clamp_block,
)

__all__ = [
    "fused_infer_cuda",
    "fused_infer_plain",
    "fused_infer_sparse_cuda",
    "fused_infer_sparse_plain",
]


def fused_infer_plain(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """int32 ``[B, M]`` class sums in plain PyTorch (int8 weights semantics)."""
    fired = cl.eval_clauses_bitpacked(lit_packed, include_packed, nonempty)
    return cl.class_sums(fired, weights)


def fused_infer_sparse_plain(
    lit_packed: torch.Tensor, exclude_packed: torch.Tensor, weights_active: torch.Tensor
) -> torch.Tensor:
    """int32 ``[B, M]`` class sums over the active clauses, plain PyTorch."""
    return cl.class_sums(cl.eval_clauses_sparse(lit_packed, exclude_packed), weights_active)


def _entry(name: str):
    """The C entry point ``name``, built and loaded on first use."""
    n_ptrs = 5 if name == "fused_infer" else 4
    return _build.entry("fused_infer", name,
                        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _check_weights(weights: torch.Tensor, c: int) -> None:
    if weights.dim() != 2 or weights.shape[1] != c:
        raise ValueError(f"weights must be [M, {c}]; got {list(weights.shape)}")


def fused_infer_cuda(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    weights: torch.Tensor,
    *,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Launch the CUDA fused kernel; every operand on one CUDA card.
    Weights are taken as int8 (the servable's clamp), ``nonempty`` as
    0/1.  ``block_c`` clauses per tile (shrunk to C rounded up to 32).
    Returns int32 ``[B, M]``."""
    check_block_c(block_c)
    check_words(lit_packed, include_packed)
    b, p, w = lit_packed.shape
    c = include_packed.shape[0]
    if tuple(nonempty.shape) != (c,):
        raise ValueError(f"nonempty must be [{c}]; got {list(nonempty.shape)}")
    _check_weights(weights, c)
    dev = check_cuda("fused_infer_cuda", lit_packed, include_packed, nonempty, weights)
    m = weights.shape[0]
    lit = lit_packed.contiguous()
    inc = include_packed.contiguous()
    ne = as_uint8(nonempty)
    w8 = weights.to(torch.int8).contiguous()
    out = torch.zeros((b, m), dtype=torch.int32, device=dev)
    if b == 0 or c == 0 or m == 0:
        return out
    fn = _entry("fused_infer")
    block_c = clamp_block(block_c, c, 32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            lit.data_ptr(), inc.data_ptr(), ne.data_ptr(), w8.data_ptr(),
            out.data_ptr(), b, p, c, w, m, block_c, int(bool(csrf)), stream,
        )
    _build.check("fused_infer", code)
    fused_infer_cuda.launches += 1
    return out


def fused_infer_sparse_cuda(
    lit_packed: torch.Tensor,
    exclude_packed: torch.Tensor,
    weights_active: torch.Tensor,
    *,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Launch the CUDA fused kernel over the active clauses (exclude words
    int32 ``[C_a, W]``, weights int8-range ``[M, C_a]``); every operand on
    one CUDA card.  Returns int32 ``[B, M]``; with ``C_a == 0`` zeros,
    without a launch."""
    check_block_c(block_c)
    check_words(lit_packed, exclude_packed)
    b, p, w = lit_packed.shape
    c = exclude_packed.shape[0]
    _check_weights(weights_active, c)
    dev = check_cuda("fused_infer_sparse_cuda", lit_packed, exclude_packed, weights_active)
    m = weights_active.shape[0]
    lit = lit_packed.contiguous()
    exc = exclude_packed.contiguous()
    w8 = weights_active.to(torch.int8).contiguous()
    out = torch.zeros((b, m), dtype=torch.int32, device=dev)
    if b == 0 or c == 0 or m == 0:
        return out
    fn = _entry("fused_infer_sparse")
    block_c = clamp_block(block_c, c, 32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            lit.data_ptr(), exc.data_ptr(), w8.data_ptr(), out.data_ptr(),
            b, p, c, w, m, block_c, int(bool(csrf)), stream,
        )
    _build.check("fused_infer_sparse", code)
    fused_infer_sparse_cuda.launches += 1
    return out


#: Launches of the CUDA kernels (plain counts; reset by callers).
fused_infer_cuda.launches = 0
fused_infer_sparse_cuda.launches = 0
