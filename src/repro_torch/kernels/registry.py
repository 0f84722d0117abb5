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

from repro_torch.kernels.fused_infer import fused_infer_cuda, fused_infer_plain
from repro_torch.kernels.ingress import ingress_pack_cuda, ingress_pack_plain

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
        Kernel(
            name="fused_infer",
            cuda=fused_infer_cuda,
            plain=fused_infer_plain,
            jax_oracle="fused_infer_ref",
            source="src/repro_torch/csrc/fused_infer.cu",
            replaces="src/repro/kernels/fused_infer.py:99 fused_infer_pallas",
        ),
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.cuda.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.cuda.launches for name, k in KERNELS.items()}
