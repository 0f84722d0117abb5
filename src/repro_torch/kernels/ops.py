"""Public kernel entry points, dispatching on the tensor's device.

  * a CUDA tensor launches the CUDA kernel (and raises when it cannot:
    no ``nvcc``, a refused launch);
  * a CPU tensor takes the kernel's plain PyTorch version;
  * ``backend="plain"`` runs the plain version on any device (the card's
    yardstick in ``chip_smoke.py``).

The four clause-tile entry points take the kernels' own parameters:
``csrf`` (the early exit) and ``block_c`` (clauses per CUDA block, a
multiple of 32 from 32 to 256, checked on every device).  Neither changes
a result; the plain versions ignore both.

The active-pool entry points (``clause_eval_sparse``, ``fused_infer_sparse``,
``matmul_sparse_infer``) take the image of ``serve.servable.analyze_sparsity``;
an empty active pool (``C_a == 0``) returns before any launch, since a grid
of 0 blocks is an invalid launch.

``threefry`` is the counter hash of ``core/prng.py``'s keys (no TPU kernel:
it stands in for XLA's lowering of ``jax.random``'s generator).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import clauses as cl
from repro_torch.kernels.class_sum import class_sum_cuda, class_sum_plain
from repro_torch.kernels.clause_eval import (
    clause_eval_cuda,
    clause_eval_plain,
    clause_eval_sparse_cuda,
    clause_eval_sparse_plain,
)
from repro_torch.kernels.fused_infer import (
    fused_infer_cuda,
    fused_infer_plain,
    fused_infer_sparse_cuda,
    fused_infer_sparse_plain,
)
from repro_torch.kernels.ingress import (
    ingress_pack_adaptive_cuda,
    ingress_pack_adaptive_plain,
    ingress_pack_cuda,
    ingress_pack_plain,
)
from repro_torch.kernels.shapes import BLOCK_C, check_block_c
from repro_torch.kernels.threefry import threefry_cuda, threefry_plain

__all__ = [
    "class_sum",
    "clause_eval",
    "clause_eval_sparse",
    "fused_infer",
    "fused_infer_from_images",
    "fused_infer_sparse",
    "ingress_pack",
    "ingress_pack_adaptive",
    "matmul_sparse_infer",
    "threefry",
]


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


def ingress_pack_adaptive(
    images: torch.Tensor, spec, block_size: int = 11, c: float = 2.0, *,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed patch literals int32 ``[B, P, W]`` from raw uint8 ``[B, Y, X]``
    pixels under the adaptive Gaussian booleanize; on the card one launch,
    and neither the booleanized bits nor the local mean reach device
    memory."""
    if _use_kernel(images, backend):
        return ingress_pack_adaptive_cuda(images, spec, block_size, c)
    return ingress_pack_adaptive_plain(images, spec, block_size, c)


def fused_infer(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    weights: torch.Tensor,
    *,
    backend: Optional[str] = None,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Clause evaluation + class sums in one kernel; int32 ``[B, M]``.
    ``csrf`` toggles the kernel's early exit and never changes the result."""
    check_block_c(block_c)
    if _use_kernel(lit_packed, backend):
        return fused_infer_cuda(lit_packed, include_packed, nonempty, weights, csrf=csrf,
                                block_c=block_c)
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
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Booleanized images -> class sums: the ingress kernel chained into the
    fused kernel; only the packed words pass through device memory."""
    lit_packed = ingress_pack(bool_images, spec, backend=backend)
    return fused_infer(lit_packed, include_packed, nonempty, weights, backend=backend,
                       csrf=csrf, block_c=block_c)


def clause_eval(
    lit_packed: torch.Tensor,
    include_packed: torch.Tensor,
    nonempty: torch.Tensor,
    *,
    backend: Optional[str] = None,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Sequential-OR clause outputs uint8 0/1 ``[B, C]`` from packed words.
    ``csrf`` toggles the kernel's early exit and never changes the result."""
    check_block_c(block_c)
    if _use_kernel(lit_packed, backend):
        return clause_eval_cuda(lit_packed, include_packed, nonempty, csrf=csrf,
                                block_c=block_c)
    return clause_eval_plain(lit_packed, include_packed, nonempty)


def class_sum(
    fired: torch.Tensor, weights: torch.Tensor, *, backend: Optional[str] = None
) -> torch.Tensor:
    """Eq. (3) class sums int32 ``[B, M]`` from fired 0/1 ``[B, C]``."""
    if _use_kernel(fired, backend):
        return class_sum_cuda(fired, weights)
    return class_sum_plain(fired, weights)


def clause_eval_sparse(
    lit_packed: torch.Tensor,
    exclude_packed: torch.Tensor,
    *,
    backend: Optional[str] = None,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Active-clause outputs uint8 0/1 ``[B, C_a]`` from packed literals and
    the active pool's exclude words."""
    check_block_c(block_c)
    if exclude_packed.shape[0] == 0:       # empty pool: nothing can fire
        return torch.zeros((lit_packed.shape[0], 0), dtype=torch.uint8,
                           device=lit_packed.device)
    if _use_kernel(lit_packed, backend):
        return clause_eval_sparse_cuda(lit_packed, exclude_packed, csrf=csrf,
                                       block_c=block_c)
    return clause_eval_sparse_plain(lit_packed, exclude_packed)


def fused_infer_sparse(
    lit_packed: torch.Tensor,
    exclude_packed: torch.Tensor,
    weights_active: torch.Tensor,
    *,
    backend: Optional[str] = None,
    csrf: bool = True,
    block_c: int = BLOCK_C,
) -> torch.Tensor:
    """Clause evaluation + class sums over the active pool in one kernel;
    int32 ``[B, M]``."""
    check_block_c(block_c)
    if exclude_packed.shape[0] == 0:
        return torch.zeros((lit_packed.shape[0], weights_active.shape[0]),
                           dtype=torch.int32, device=lit_packed.device)
    if _use_kernel(lit_packed, backend):
        return fused_infer_sparse_cuda(lit_packed, exclude_packed, weights_active,
                                       csrf=csrf, block_c=block_c)
    return fused_infer_sparse_plain(lit_packed, exclude_packed, weights_active)


def matmul_sparse_infer(
    literals: torch.Tensor, include_active: torch.Tensor, weights_active: torch.Tensor
) -> torch.Tensor:
    """Violation counts over the active pool as a float32 matmul of
    ``1 - literals`` [B, P, 2o] by ``include_active``ᵀ, in patch chunks; a
    clause fires on a patch iff its count is 0.  The reference's XLA int8
    dot, not a TPU kernel, so plain PyTorch on every device (counts are at
    most 2o <= 8192: exact).  int32 ``[B, M]``."""
    every = torch.ones(include_active.shape[0], dtype=torch.bool, device=literals.device)
    fired = cl.eval_clauses_matmul(literals, include_active, every)
    return cl.class_sums(fired, weights_active)


def threefry(
    keys: torch.Tensor,
    n: int,
    mode: str = "bits",
    *,
    start: int = 0,
    minval: float = 0.0,
    maxval: float = 1.0,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Threefry2x32-20 of int32 keys ``[K, 2]`` at counters ``start ..
    start + n - 1``: ``"bits"`` int32 ``[K, n]``, ``"uniform"`` float32
    ``[K, n]`` in ``[minval, maxval)``, or ``"pairs"`` int32 ``[K, n, 2]``."""
    if _use_kernel(keys, backend):
        return threefry_cuda(keys, n, mode, start=start, minval=minval, maxval=maxval)
    return threefry_plain(keys, n, mode, start=start, minval=minval, maxval=maxval)
