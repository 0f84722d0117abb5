"""Operand checks and block/grid shape helpers for the CUDA kernel wrappers.

The kernels mask their ragged edges themselves, so nothing here pads an
operand: the wrappers only check operands and size blocks and grids.
"""

from __future__ import annotations

import torch

__all__ = ["BLOCK_C", "as_uint8", "check_block_c", "check_cuda", "check_words",
           "clamp_block", "round_up"]

#: Clauses per CUDA block of the tile kernels (one tile of the
#: sequential-OR register), unless the caller names another ``block_c``.
BLOCK_C = 128


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= ``x``."""
    return (x + multiple - 1) // multiple * multiple


def clamp_block(block: int, extent: int, multiple: int) -> int:
    """The requested ``block``, shrunk to ``extent`` rounded up to
    ``multiple`` when the axis is smaller than one block."""
    return min(block, round_up(extent, multiple))


def check_block_c(block_c: int) -> int:
    """``block_c`` as the tile kernels take it (``csrc/fused_infer.cu`` and
    ``csrc/clause_eval.cu``): a multiple of 32 from 32 to 256."""
    if isinstance(block_c, bool) or not isinstance(block_c, int) or not (
        32 <= block_c <= 256 and block_c % 32 == 0
    ):
        raise ValueError(f"block_c must be a multiple of 32 in [32, 256]; got {block_c!r}")
    return block_c


def check_words(lit_packed: torch.Tensor, model_packed: torch.Tensor) -> None:
    """Literal words ``[B, P, W]`` and model words ``[C, W]``, both int32."""
    if lit_packed.dim() != 3 or model_packed.dim() != 2:
        raise ValueError("lit_packed must be [B, P, W] and the model words [C, W]")
    w = lit_packed.shape[2]
    if model_packed.shape[1] != w:
        raise ValueError(f"word counts differ: literals {w}, model {model_packed.shape[1]}")
    for name, t in (("lit_packed", lit_packed), ("model words", model_packed)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must hold int32 words, got {t.dtype}")


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device every operand lies on; raises otherwise."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device")
    return dev


def as_uint8(flags: torch.Tensor) -> torch.Tensor:
    """0/1 flags as contiguous uint8, with no conversion kernel for uint8
    or bool (one byte of 0/1, viewed); other types become ``flags != 0``."""
    if flags.dtype == torch.bool:
        return flags.contiguous().view(torch.uint8)
    if flags.dtype == torch.uint8:
        return flags.contiguous()
    return (flags != 0).to(torch.uint8).contiguous()
