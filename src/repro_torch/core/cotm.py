"""ConvCoTM configuration and model state (counterpart of ``repro/core/cotm.py``).

  * ``ta_state``: uint8 ``[C, 2o]`` Tsetlin-automaton counters; the TA
    action (include) is ``state >= N`` with N = 128.
  * ``weights``: int32 ``[m, C]`` signed clause weights (int8 range on the
    ASIC; :func:`repro_torch.serve.servable.freeze` clamps them).

:func:`infer` and :func:`infer_packed` run Algorithm 1 through the eval
path registry (``serve/paths.py``), freezing the model on every call;
long-running callers freeze once and serve through ``serve/engine.py``.

Random initialisation takes a ``jax.random`` key (``core/prng.py``): from
one key both packages draw the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.patches import PatchSpec

__all__ = [
    "CoTMConfig",
    "CoTMModel",
    "GeometryBounds",
    "MAX_GEOMETRY",
    "init_model",
    "init_boundary_model",
    "infer",
    "infer_packed",
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
    """Static hyper-parameters of a ConvCoTM (paper values as defaults).

    Field names, order and defaults equal the reference's, so ``repr``
    (which :func:`repro_torch.serve.servable.servable_digest` hashes) is
    the same string in both packages."""

    n_clauses: int = 128
    n_classes: int = 10
    patch: PatchSpec = dataclasses.field(default_factory=PatchSpec)
    # Training hyper-parameters (TMU-compatible).
    T: int = 500                 # class-sum clip threshold
    s: float = 10.0              # specificity
    boost_true_positive: bool = True
    max_included_literals: Optional[int] = None   # literal budget
    eval_path: str = "matmul"    # default serving path (serve/paths.py)
    # Training-time clause evaluation in core/train.py: 'matmul' (float32
    # violation counts) or 'dense' (the [P, C, 2o] broadcast); equal.
    train_eval: str = "matmul"

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

    @property
    def model_bits(self) -> int:
        """Register-image size: TA actions + 8-bit weights (45,056 for the paper)."""
        return self.n_clauses * self.n_literals + self.n_classes * self.n_clauses * 8


@dataclasses.dataclass
class CoTMModel:
    """Trainable ConvCoTM state."""

    ta_state: torch.Tensor       # uint8 [C, 2o]
    weights: torch.Tensor        # int32 [m, C]

    @property
    def include(self) -> torch.Tensor:
        """TA action signals: uint8 0/1 [C, 2o]."""
        return (self.ta_state >= TA_HALF).to(torch.uint8)


def init_model(key: torch.Tensor, config: CoTMConfig) -> CoTMModel:
    """All TAs at N-1 (weakly exclude); weights +-1 from
    ``bernoulli(key, 0.5)``, as the reference draws them.  Tensors land on
    the key's device."""
    ta = torch.full(
        (config.n_clauses, config.n_literals), TA_HALF - 1, dtype=torch.uint8,
        device=key.device,
    )
    signs = prng.bernoulli(key, 0.5, (config.n_classes, config.n_clauses))
    weights = torch.where(signs, 1, -1).to(torch.int32)
    return CoTMModel(ta_state=ta, weights=weights)


def init_boundary_model(key: torch.Tensor, config: CoTMConfig, spread: int = 10) -> CoTMModel:
    """Untrained model with TA states in ``[N - spread, N + spread)``, so
    include masks are nondegenerate without training (serving demos,
    benchmarks, tests): the reference's ``split`` of ``key`` into the
    weights' key and the states' ``randint`` key."""
    k_weights, k_ta = prng.split(key)
    model = init_model(k_weights, config)
    model.ta_state = prng.randint(
        k_ta, tuple(model.ta_state.shape), TA_HALF - spread, TA_HALF + spread
    ).to(torch.uint8)
    return model


def infer(
    model: CoTMModel, images: torch.Tensor, config: CoTMConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1 for booleanized uint8 0/1 images ``[B, Y, X]`` (or
    ``[B, Y, X, Z, U]``) on the eval path ``config.eval_path``; returns
    (predictions int32 ``[B]``, class sums int32 ``[B, m]``)."""
    from repro_torch.core import clauses as cl
    from repro_torch.core.patches import extract_patch_features, make_literals, pack_bits
    from repro_torch.serve import paths as sp
    from repro_torch.serve.servable import freeze

    sm = freeze(model, config)
    path = sp.get_path(config.eval_path)
    lits = make_literals(extract_patch_features(images, config.patch))
    if path.input_form == sp.PACKED:
        lits = pack_bits(lits)
    v = sp.run_path(path, sm, lits)
    return cl.argmax_predict(v), v


def infer_packed(
    model: CoTMModel,
    lit_packed: torch.Tensor,
    config: CoTMConfig,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference from packed int32 literal words ``[B, P, W]``: on
    ``config.eval_path`` when it takes packed literals, else on
    ``bitpacked``; ``use_kernel`` takes the ``kernel`` path (the CUDA
    clause-eval kernel on the card)."""
    from repro_torch.core import clauses as cl
    from repro_torch.serve import paths as sp
    from repro_torch.serve.servable import freeze

    if use_kernel:
        path = sp.get_path("kernel")
    else:
        path = sp.get_path(config.eval_path)
        if path.input_form != sp.PACKED:
            path = sp.get_path("bitpacked")
    v = sp.run_path(path, freeze(model, config), lit_packed)
    return cl.argmax_predict(v), v
