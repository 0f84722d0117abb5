"""Kernel registry: every CUDA kernel names its plain version and its oracle.

Each entry ties one CUDA kernel to the plain PyTorch version it is held
against on the card, to the oracle in the JAX package's
``kernels/ref.py`` that the tests hold the plain version against (a
string only: this package never imports the JAX package), and to the TPU
kernel it replaces.  :func:`reset_launches` and :func:`launch_counts`
read the wrappers' launch counters, so a run can show that its main path
went through every kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

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
from repro_torch.kernels.threefry import threefry_cuda, threefry_plain

__all__ = ["KERNELS", "Kernel", "launch_counts", "reset_launches"]


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    cuda: Callable          # the wrapper that launches the kernel (has .launches)
    plain: Callable         # the plain PyTorch version
    jax_oracle: str         # repro.kernels.ref function the tests compare with
    source: str             # the CUDA source, repo-relative
    replaces: str           # the TPU kernel, file:line and function


KERNELS: Dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel(
            name="ingress_pack",
            cuda=ingress_pack_cuda,
            plain=ingress_pack_plain,
            jax_oracle="ingress_pack_ref",
            source="src/repro_torch/csrc/ingress_pack.cu",
            replaces="src/repro/kernels/ingress.py:94 ingress_pack_pallas",
        ),
        # The same kernel in its adaptive mode: the reference booleanizes
        # with XLA's operations, then packs in the Pallas kernel; its
        # oracle is ingress_pack_ref over adaptive_gaussian_booleanize.
        Kernel(
            name="ingress_pack_adaptive",
            cuda=ingress_pack_adaptive_cuda,
            plain=ingress_pack_adaptive_plain,
            jax_oracle="ingress_pack_ref",
            source="src/repro_torch/csrc/ingress_pack.cu",
            replaces="src/repro/kernels/ingress.py:94 ingress_pack_pallas",
        ),
        Kernel(
            name="fused_infer",
            cuda=fused_infer_cuda,
            plain=fused_infer_plain,
            jax_oracle="fused_infer_ref",
            source="src/repro_torch/csrc/fused_infer.cu",
            replaces="src/repro/kernels/fused_infer.py:99 fused_infer_pallas",
        ),
        Kernel(
            name="fused_infer_sparse",
            cuda=fused_infer_sparse_cuda,
            plain=fused_infer_sparse_plain,
            jax_oracle="sparse_infer_ref",
            source="src/repro_torch/csrc/fused_infer.cu",
            replaces="src/repro/kernels/fused_infer.py:204 fused_infer_sparse_pallas",
        ),
        Kernel(
            name="clause_eval",
            cuda=clause_eval_cuda,
            plain=clause_eval_plain,
            jax_oracle="clause_eval_ref",
            source="src/repro_torch/csrc/clause_eval.cu",
            replaces="src/repro/kernels/clause_eval.py:117 clause_eval_pallas",
        ),
        Kernel(
            name="clause_eval_sparse",
            cuda=clause_eval_sparse_cuda,
            plain=clause_eval_sparse_plain,
            jax_oracle="clause_eval_sparse_ref",
            source="src/repro_torch/csrc/clause_eval.cu",
            replaces="src/repro/kernels/clause_eval.py:224 clause_eval_sparse_pallas",
        ),
        Kernel(
            name="class_sum",
            cuda=class_sum_cuda,
            plain=class_sum_plain,
            jax_oracle="class_sum_ref",
            source="src/repro_torch/csrc/class_sum.cu",
            replaces="src/repro/kernels/class_sum.py:49 class_sum_pallas",
        ),
        Kernel(
            name="threefry",
            cuda=threefry_cuda,
            plain=threefry_plain,
            jax_oracle="jax.random.bits",
            source="src/repro_torch/csrc/threefry.cu",
            replaces="(none: XLA's lowering of jax.random's threefry2x32)",
        ),
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.cuda.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.cuda.launches for name, k in KERNELS.items()}
