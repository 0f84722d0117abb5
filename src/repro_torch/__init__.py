"""PyTorch / CUDA port of the ConvCoTM serving stack and trainer, and of the
LM substrate's serving path, for NVIDIA Hopper.

A second package beside ``repro`` (the JAX reference).  It imports
``torch`` and numpy only: never ``jax`` and nothing of ``repro``; the
tests hold it bit for bit against the reference.  Layout follows the
reference package module by module (``core/``, ``kernels/``, ``serve/``,
``data/``, ``train/``, ``checkpoint/``, ``launch/``).  Every TPU kernel of
the reference has a CUDA C++ counterpart under ``csrc/``: ingress pack,
fused clause-eval + class sums (dense and active pool), clause eval
(dense and active pool) and class sums; they serve the ``fused``,
``kernel``, ``sparse`` and ``fused_sparse`` eval paths, for models served
as they are and for models the trainer hands over.  Above the engine sit
the reference's async service (``serve/service.py``: admission,
microbatching, deadlines, quarantine, the circuit breaker), its hot swap
and rollback, the train -> shadow -> promote lifecycle
(``launch/lifecycle.py``), the per-bucket autotuner over the eval paths and
the CUDA kernels' parameters (``serve/autotune.py``), and the ConvCoTM
roofline model with the H100's ceilings (``roofline/``).  The engine and
the trainer run across a device mesh (``launch/mesh.py``,
``serve/mesh.py``, ``distributed/``): one process drives every shard,
replicated or clause-sharded, with exact int32 reductions between shards.

The LM substrate's serving path sits beside it: the ten architecture
configs (``configs.ARCHS``, ``get_config``), the decoder, MoE, RG-LRU,
xLSTM and encoder-decoder blocks (``models/``), ``prefill``/``decode``
(``train/serve_step.py``) and :func:`generate` (``launch/serve.py``), in
plain PyTorch (no kernel of its own), with the forward half of the LM
roofline model.  ``convert.lm_params_from_arrays`` carries the reference's
parameters across.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`resolve_device`); with no device given and
no card present they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

__all__ = [
    "ARCHS",
    "AutotuneReport",
    "DeviceMesh",
    "ServeMesh",
    "TunedPlan",
    "autotune_servable",
    "generate",
    "get_config",
    "make_serve_device_mesh",
    "make_serve_mesh",
    "make_test_mesh",
    "resolve_device",
    "tm_path_roofline",
    "tm_serve_costs",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA card.  Raises when no device is given and CUDA is absent,
    so a run never drops to the CPU unasked."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


# Below resolve_device: the modules these import take it from this package.
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    DeviceMesh,
    make_serve_device_mesh,
    make_test_mesh,
)
from repro_torch.roofline import tm_path_roofline, tm_serve_costs  # noqa: E402
from repro_torch.serve.autotune import (  # noqa: E402
    AutotuneReport,
    TunedPlan,
    autotune_servable,
)
from repro_torch.serve.mesh import ServeMesh, make_serve_mesh  # noqa: E402
