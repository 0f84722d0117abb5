"""Registry of ConvCoTM evaluation paths (counterpart of ``repro/serve/paths.py``).

Every path computes Eq. (3) class sums int32 ``[B, m]`` from one batch's
literals and a :class:`~repro_torch.serve.servable.ServableModel`.  A path
declares its literal input form (``dense`` uint8 0/1 ``[B, P, 2o]`` or
``packed`` int32 ``[B, P, W]``); :func:`run_path_raw` runs the ingress in
that form and then the path, from raw pixels to class sums.

Ported paths: ``dense``, ``matmul``, ``bitpacked`` and ``fused`` (the
CUDA ingress-pack and fused kernels on the card).  The sparse paths, the
``kernel`` path, tunable parameters and the degradation chain are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import clauses as cl
from repro_torch.core.ingress import IngressSpec, apply_ingress
from repro_torch.kernels import ops as kops

__all__ = [
    "DENSE",
    "PACKED",
    "EvalPath",
    "available_paths",
    "get_path",
    "register_path",
    "run_path",
    "run_path_raw",
]

#: fn(literals, include, include_packed, nonempty, weights) -> int32 [B, m]
PathFn = Callable[..., torch.Tensor]

DENSE = "dense"
PACKED = "packed"


@dataclasses.dataclass(frozen=True)
class EvalPath:
    """A registered evaluation path (name, literal form, eval fn)."""

    name: str
    input_form: str          # DENSE | PACKED
    fn: PathFn

    def __post_init__(self):
        if self.input_form not in (DENSE, PACKED):
            raise ValueError(f"input_form must be '{DENSE}' or '{PACKED}'")

    def ingress_spec(self, patch, method: str = "threshold", **kw) -> IngressSpec:
        """The :class:`IngressSpec` matching this path's literal form."""
        return IngressSpec(
            patch=patch, method=method, packed=self.input_form == PACKED, **kw
        )


_REGISTRY: Dict[str, EvalPath] = {}


def register_path(name: str, input_form: str) -> Callable[[PathFn], PathFn]:
    """Decorator: register ``fn`` as evaluation path ``name``."""

    def deco(fn: PathFn) -> PathFn:
        if name in _REGISTRY:
            raise ValueError(f"eval path {name!r} already registered")
        _REGISTRY[name] = EvalPath(name=name, input_form=input_form, fn=fn)
        return fn

    return deco


def get_path(name: str) -> EvalPath:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown eval path {name!r}; registered: {available_paths()}"
        ) from None


def available_paths() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def run_path(path: EvalPath, servable, literals: torch.Tensor) -> torch.Tensor:
    """Class sums int32 [B, m]; ``literals`` must be in ``path.input_form``."""
    return path.fn(
        literals,
        servable.include,
        servable.include_packed,
        servable.nonempty,
        servable.weights,
    )


def run_path_raw(
    path: EvalPath, servable, raw: torch.Tensor, ingress: IngressSpec
) -> torch.Tensor:
    """Class sums int32 [B, m] straight from raw pixels: the ingress in the
    path's literal form, then the path, all on ``raw``'s device."""
    if ingress.packed != (path.input_form == PACKED):
        ingress = dataclasses.replace(ingress, packed=path.input_form == PACKED)
    return run_path(path, servable, apply_ingress(ingress, raw))


# --- the ported paths ------------------------------------------------------

@register_path("dense", DENSE)
def _dense(lits, include, include_packed, nonempty, weights):
    return cl.class_sums(cl.eval_clauses_dense(lits, include), weights)


@register_path("matmul", DENSE)
def _matmul(lits, include, include_packed, nonempty, weights):
    return cl.class_sums(cl.eval_clauses_matmul(lits, include, nonempty), weights)


@register_path("bitpacked", PACKED)
def _bitpacked(lits, include, include_packed, nonempty, weights):
    fired = cl.eval_clauses_bitpacked(lits, include_packed, nonempty)
    return cl.class_sums(fired, weights)


@register_path("fused", PACKED)
def _fused(lits, include, include_packed, nonempty, weights):
    return kops.fused_infer(lits, include_packed, nonempty, weights)
