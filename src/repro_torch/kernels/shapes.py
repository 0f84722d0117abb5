"""Block and grid shape helpers for the CUDA kernel wrappers.

The kernels mask their ragged edges themselves, so nothing here pads an
operand: the wrappers only size blocks and grids.
"""

from __future__ import annotations

__all__ = ["clamp_block", "round_up"]


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= ``x``."""
    return (x + multiple - 1) // multiple * multiple


def clamp_block(block: int, extent: int, multiple: int) -> int:
    """The requested ``block``, shrunk to ``extent`` rounded up to
    ``multiple`` when the axis is smaller than one block."""
    return min(block, round_up(extent, multiple))

