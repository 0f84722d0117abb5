"""Public kernel entry points, dispatching on the tensor's device.

  * a CUDA tensor launches the CUDA kernel (and raises when it cannot:
    no ``nvcc``, a refused launch);
  * a CPU tensor takes the kernel's plain PyTorch version;
  * ``backend="plain"`` runs the plain version on any device (the card's
    yardstick in ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_infer import fused_infer_cuda, fused_infer_plain
from repro_torch.kernels.ingress import ingress_pack_cuda, ingress_pack_plain

__all__ = ["fused_infer", "fused_infer_from_images", "ingress_pack"]


def _use_kernel(t: torch.Tensor, backend: Optional[str]) -> bool:
    if backend is None:
        return t.is_cuda
    if backend == "plain":
        return False
    raise ValueError(f"backend must be None or 'plain'; got {backend!r}")


def ingress_pack(
    bool_images: torch.Tensor, spec, *, backend: Optional[str] = None
) -> torch.Tensor:
    """Packed patch literals int32 ``[B, P, W]`` from booleanized uint8
    ``[B, Y, X]``; on the card the dense literal bits never reach device
    memory."""
    if _use_kernel(bool_images, backend):
        return ingress_pack_cuda(bool_images, spec)
    return ingress_pack_plain(bool_images, spec)


def fused_infer(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    weights: torch.Tensor,
    *,
    backend: Optional[str] = None,
    csrf: bool = True,
) -> torch.Tensor:
    """Clause evaluation + class sums in one kernel; int32 ``[B, M]``.
    ``csrf`` toggles the kernel's early exit and never changes the result."""
    if _use_kernel(lit_packed, backend):
        return fused_infer_cuda(lit_packed, include_packed, nonempty, weights, csrf=csrf)
    return fused_infer_plain(lit_packed, include_packed, nonempty, weights)


def fused_infer_from_images(
    bool_images: torch.Tensor,
    spec,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    weights: torch.Tensor,
    *,
    backend: Optional[str] = None,
    csrf: bool = True,
) -> torch.Tensor:
    """Booleanized images -> class sums: the ingress kernel chained into the
    fused kernel; only the packed words pass through device memory."""
    lit_packed = ingress_pack(bool_images, spec, backend=backend)
    return fused_infer(
        lit_packed, include_packed, nonempty, weights, backend=backend, csrf=csrf
    )
