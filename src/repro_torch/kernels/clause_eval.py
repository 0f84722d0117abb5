"""Clause-eval kernels: sequential-OR clause outputs, dense and active pool.

Replaces the TPU kernels ``src/repro/kernels/clause_eval.py``:
``clause_eval_pallas`` and ``clause_eval_sparse_pallas``, with the two
instantiations of the CUDA kernel ``csrc/clause_eval.cu`` (its source note
gives the bound and the design).  :func:`clause_eval_cuda` and
:func:`clause_eval_sparse_cuda` launch them and return uint8 0/1 clause
outputs; :func:`clause_eval_plain` and :func:`clause_eval_sparse_plain`
are the plain PyTorch versions.
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
    "clause_eval_cuda",
    "clause_eval_plain",
    "clause_eval_sparse_cuda",
    "clause_eval_sparse_plain",
]


def clause_eval_plain(
    lit_packed: torch.Tensor, include_packed: torch.Tensor, nonempty: torch.Tensor
) -> torch.Tensor:
    """uint8 0/1 ``[B, C]`` clause outputs in plain PyTorch."""
    return cl.eval_clauses_bitpacked(lit_packed, include_packed, nonempty)


def clause_eval_sparse_plain(
    lit_packed: torch.Tensor, exclude_packed: torch.Tensor
) -> torch.Tensor:
    """uint8 0/1 ``[B, C_a]`` active-clause outputs in plain PyTorch."""
    return cl.eval_clauses_sparse(lit_packed, exclude_packed)


def _entry(name: str):
    """The C entry point ``name``, built and loaded on first use."""
    n_ptrs = 4 if name == "clause_eval" else 3
    return _build.entry("clause_eval", name,
                        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _launch(wrapper, name: str, ptrs, lit: torch.Tensor, c: int, csrf: bool,
            block_c: int) -> torch.Tensor:
    """Run entry point ``name`` over ``lit`` and model pointers ``ptrs``
    in tiles of ``block_c`` clauses, counting the launch on ``wrapper``;
    returns the uint8 ``[B, C]`` output it fills."""
    b, p, w = lit.shape
    out = torch.empty((b, c), dtype=torch.uint8, device=lit.device)
    if b == 0 or c == 0:
        return out
    fn = _entry(name)
    block_c = clamp_block(block_c, c, 32)
    with torch.cuda.device(lit.device):
        stream = torch.cuda.current_stream(lit.device).cuda_stream
        code = fn(lit.data_ptr(), *ptrs, out.data_ptr(), b, p, c, w, block_c,
                  int(bool(csrf)), stream)
    _build.check(name, code)
    wrapper.launches += 1
    return out


def clause_eval_cuda(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    *,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Launch the CUDA clause-eval kernel; every operand on one CUDA card,
    ``nonempty`` taken as 0/1; ``block_c`` clauses per tile (shrunk to C
    rounded up to 32).  Returns uint8 0/1 ``[B, C]``."""
    check_block_c(block_c)
    check_words(lit_packed, include_packed)
    c = include_packed.shape[0]
    if tuple(nonempty.shape) != (c,):
        raise ValueError(f"nonempty must be [{c}]; got {list(nonempty.shape)}")
    check_cuda("clause_eval_cuda", lit_packed, include_packed, nonempty)
    inc = include_packed.contiguous()
    ne = as_uint8(nonempty)
    return _launch(clause_eval_cuda, "clause_eval", (inc.data_ptr(), ne.data_ptr()),
                   lit_packed.contiguous(), c, csrf, block_c)


def clause_eval_sparse_cuda(
    lit_packed: torch.Tensor,
    exclude_packed: torch.Tensor,
    *,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Launch the CUDA clause-eval kernel over the active clauses (exclude
    words int32 ``[C_a, W]``); every operand on one CUDA card.  Returns
    uint8 0/1 ``[B, C_a]``; with ``C_a == 0`` an empty tensor, without a
    launch."""
    check_block_c(block_c)
    check_words(lit_packed, exclude_packed)
    check_cuda("clause_eval_sparse_cuda", lit_packed, exclude_packed)
    exc = exclude_packed.contiguous()
    return _launch(clause_eval_sparse_cuda, "clause_eval_sparse", (exc.data_ptr(),),
                   lit_packed.contiguous(), exc.shape[0], csrf, block_c)


#: Launches of the CUDA kernels (plain counts; reset by callers).
clause_eval_cuda.launches = 0
clause_eval_sparse_cuda.launches = 0
