"""ConvCoTM configuration and model state (counterpart of ``repro/core/cotm.py``).

  * ``ta_state``: uint8 ``[C, 2o]`` Tsetlin-automaton counters; the TA
    action (include) is ``state >= N`` with N = 128.
  * ``weights``: int32 ``[m, C]`` signed clause weights (int8 range on the
    ASIC; :func:`repro_torch.serve.servable.freeze` clamps them).

Random initialisation takes an explicit ``torch.Generator``.  Its numbers
differ from ``jax.random``'s for the same seed; to hold the port against
the reference, carry the reference's arrays across with
:mod:`repro_torch.convert`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.patches import PatchSpec

__all__ = [
    "CoTMConfig",
    "CoTMModel",
    "GeometryBounds",
    "MAX_GEOMETRY",
    "init_model",
    "init_boundary_model",
]

TA_HALF = 128          # N: include iff state >= N (8-bit TA)
WEIGHT_MAX = 127       # int8 two's-complement clamp (Sec. IV-B)
WEIGHT_MIN = -127


@dataclasses.dataclass(frozen=True)
class GeometryBounds:
    """The largest model geometry the integer datapath supports.

    The reference proves its accumulators overflow-free at exactly this
    envelope; the CUDA kernels are sized for it too (int32 class sums,
    shared-memory clause tiles up to W = 256 words)."""

    n_clauses: int = 1024      # C
    n_classes: int = 64        # m
    n_literals: int = 8192     # 2o
    n_patches: int = 2048      # P

    def admits(self, n_clauses: int, n_classes: int, n_literals: int,
               n_patches: int) -> bool:
        return (
            n_clauses <= self.n_clauses
            and n_classes <= self.n_classes
            and n_literals <= self.n_literals
            and n_patches <= self.n_patches
        )


MAX_GEOMETRY = GeometryBounds()


@dataclasses.dataclass(frozen=True)
class CoTMConfig:
    """Static hyper-parameters of a ConvCoTM (paper values as defaults)."""

    n_clauses: int = 128
    n_classes: int = 10
    patch: PatchSpec = dataclasses.field(default_factory=PatchSpec)
    T: int = 500                 # class-sum clip threshold (training)
    s: float = 10.0              # specificity (training)
    eval_path: str = "matmul"    # default serving path (serve/paths.py)

    def __post_init__(self):
        if not MAX_GEOMETRY.admits(
            self.n_clauses, self.n_classes,
            self.patch.n_literals, self.patch.n_patches,
        ):
            raise ValueError(
                f"geometry (C={self.n_clauses}, m={self.n_classes}, "
                f"2o={self.patch.n_literals}, P={self.patch.n_patches}) "
                f"exceeds the supported envelope {MAX_GEOMETRY}"
            )

    @property
    def n_literals(self) -> int:
        return self.patch.n_literals


@dataclasses.dataclass
class CoTMModel:
    """Trainable ConvCoTM state."""

    ta_state: torch.Tensor       # uint8 [C, 2o]
    weights: torch.Tensor        # int32 [m, C]

    @property
    def include(self) -> torch.Tensor:
        """TA action signals: uint8 0/1 [C, 2o]."""
        return (self.ta_state >= TA_HALF).to(torch.uint8)


def init_model(generator: torch.Generator, config: CoTMConfig) -> CoTMModel:
    """All TAs at N-1 (weakly exclude); weights random +-1.  Tensors land
    on the generator's device."""
    dev = generator.device
    ta = torch.full(
        (config.n_clauses, config.n_literals), TA_HALF - 1, dtype=torch.uint8, device=dev
    )
    signs = torch.randint(
        0, 2, (config.n_classes, config.n_clauses), generator=generator, device=dev
    )
    weights = torch.where(signs > 0, 1, -1).to(torch.int32)
    return CoTMModel(ta_state=ta, weights=weights)


def init_boundary_model(
    generator: torch.Generator, config: CoTMConfig, spread: int = 10
) -> CoTMModel:
    """Untrained model with TA states in ``[N - spread, N + spread)``, so
    include masks are nondegenerate without training (serving demos,
    benchmarks, tests)."""
    model = init_model(generator, config)
    model.ta_state = torch.randint(
        TA_HALF - spread, TA_HALF + spread, tuple(model.ta_state.shape),
        generator=generator, device=generator.device,
    ).to(torch.uint8)
    return model
