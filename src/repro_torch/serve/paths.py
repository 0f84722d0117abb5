"""Registry of ConvCoTM evaluation paths (counterpart of ``repro/serve/paths.py``).

Every path computes Eq. (3) class sums int32 ``[B, m]`` from one batch's
literals and a :class:`~repro_torch.serve.servable.ServableModel`.  A path
declares its literal input form (``dense`` uint8 0/1 ``[B, P, 2o]`` or
``packed`` int32 ``[B, P, W]``); :data:`RAW` names the third request form,
raw uint8 pixels ``[B, H, W]``, which :func:`run_path_raw` takes through
the path's ``ingress_fn`` (default :func:`~repro_torch.core.ingress.apply_ingress`)
in that form and then the path, from raw pixels to class sums.

Ported paths: ``dense``, ``matmul`` and ``bitpacked`` (plain PyTorch);
``kernel`` (CUDA clause-eval kernel) and ``fused`` (CUDA fused kernel);
and the clause-sparsity paths over the active pool of
``servable.sparsity`` (see :func:`repro_torch.serve.servable.analyze_sparsity`):
``sparse`` (CUDA sparse clause-eval kernel), ``fused_sparse`` (CUDA sparse
fused kernel) and ``matmul_sparse`` (plain float32 matmul).  Every packed
path on the card takes its literals from the CUDA ingress-pack kernel.

A sparse path declares a dense ``fallback`` with the same input form and
bit-identical class sums; :func:`resolve_path` runs it for a servable with
no sparsity image.  :func:`degraded_fallback` walks the reference's
degradation chain.

Tunable parameters: ``tunable`` lists the parameter sets (hashable
``((name, value), ...)`` tuples, :data:`Params`) the autotuner
(``serve/autotune.py``) may sweep; ``()``, the path's defaults, always
works.  The kernel paths sweep the CUDA kernels' own parameters,
``block_c`` (clauses per CUDA block) and ``csrf`` (the early exit), where
the reference sweeps its Pallas grid's ``block_b``/``block_p``: one CUDA
block owns one image, and the patch chunk follows from shared memory, so
neither has a meaning here.  No parameter changes a result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import clauses as cl
from repro_torch.core.ingress import IngressSpec, apply_ingress
from repro_torch.kernels import ops as kops
from repro_torch.spans import span

__all__ = [
    "DENSE",
    "PACKED",
    "RAW",
    "EvalPath",
    "Params",
    "available_paths",
    "degraded_fallback",
    "get_path",
    "register_path",
    "resolve_path",
    "run_path",
    "run_path_raw",
]

#: fn(literals, include, include_packed, nonempty, weights, [sparsity,]
#: **params) -> int32 [B, m]; the ``sparsity`` positional is passed to
#: ``needs_sparsity`` paths only.
PathFn = Callable[..., torch.Tensor]

#: ingress_fn(spec, raw) -> literals in the path's input form.
IngressFn = Callable[[IngressSpec, torch.Tensor], torch.Tensor]

#: A parameter set: hashable ((name, value), ...) pairs.
Params = Tuple[Tuple[str, object], ...]

DENSE = "dense"
PACKED = "packed"
#: The raw request form: uint8 pixel batches, taken to literals on the
#: device by the path's ``ingress_fn``.
RAW = "raw"

#: The CUDA tile kernels' candidates: ``block_c`` 32 and 64 beside the
#: default 128, and CSRF off.  No 256: at the paper's C=128, ``clamp_block``
#: shrinks it to 128, the default.
_KERNEL_TUNABLE: Tuple[Params, ...] = (
    (),
    (("block_c", 32),),
    (("block_c", 64),),
    (("csrf", False),),
    (("block_c", 64), ("csrf", False)),
)


@dataclasses.dataclass(frozen=True)
class EvalPath:
    """A registered evaluation path (name, literal form, eval and ingress fns).

    ``needs_sparsity`` paths receive ``servable.sparsity`` as an extra
    positional argument; ``fallback`` names the bit-identical dense twin
    run when no sparsity image is attached (same ``input_form``).
    ``tunable`` lists the parameter sets the autotuner may sweep.
    """

    name: str
    input_form: str          # DENSE | PACKED
    fn: PathFn
    ingress_fn: IngressFn = apply_ingress
    needs_sparsity: bool = False
    fallback: Optional[str] = None
    tunable: Tuple[Params, ...] = ((),)

    def __post_init__(self):
        if self.input_form not in (DENSE, PACKED):
            raise ValueError(f"input_form must be '{DENSE}' or '{PACKED}'")
        if self.needs_sparsity and self.fallback is None:
            raise ValueError(f"sparse path {self.name!r} must declare a dense fallback")

    def ingress_spec(self, patch, method: str = "threshold", **kw) -> IngressSpec:
        """The :class:`IngressSpec` matching this path's literal form."""
        return IngressSpec(
            patch=patch, method=method, packed=self.input_form == PACKED, **kw
        )


_REGISTRY: Dict[str, EvalPath] = {}


def register_path(
    name: str,
    input_form: str,
    *,
    ingress_fn: Optional[IngressFn] = None,
    needs_sparsity: bool = False,
    fallback: Optional[str] = None,
    tunable: Tuple[Params, ...] = ((),),
) -> Callable[[PathFn], PathFn]:
    """Decorator: register ``fn`` as evaluation path ``name``.
    ``ingress_fn`` replaces :func:`apply_ingress` for this path (same
    contract, literals in ``input_form``).  ``fallback`` (required with
    ``needs_sparsity``) must already be registered with the same input
    form."""

    def deco(fn: PathFn) -> PathFn:
        if name in _REGISTRY:
            raise ValueError(f"eval path {name!r} already registered")
        if fallback is not None and get_path(fallback).input_form != input_form:
            raise ValueError(
                f"fallback {fallback!r} input form {get_path(fallback).input_form!r} "
                f"!= {input_form!r}"
            )
        _REGISTRY[name] = EvalPath(name=name, input_form=input_form, fn=fn,
                                   ingress_fn=ingress_fn or apply_ingress,
                                   needs_sparsity=needs_sparsity, fallback=fallback,
                                   tunable=tunable)
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


def resolve_path(path: EvalPath, servable) -> EvalPath:
    """The path actually evaluated for ``servable``: a sparse path without
    an attached sparsity image resolves to its dense fallback."""
    if path.needs_sparsity and getattr(servable, "sparsity", None) is None:
        return get_path(path.fallback)
    return path


#: The degradation chain of the reference (``repro/serve/paths.py``): one
#: step per trip of a failing path.  Sparse paths shed their sparsity onto
#: the dense twin, kernel paths shed the kernels onto plain math, and all
#: end at ``dense``.  A step may change the literal input form.
_DEGRADED_CHAIN = {
    "fused_sparse": "fused",
    "sparse": "bitpacked",
    "matmul_sparse": "matmul",
    "fused": "matmul",
    "kernel": "matmul",
    "bitpacked": "dense",
    "matmul": "dense",
    "dense": None,
}


def degraded_fallback(name: str) -> Optional[str]:
    """The next path down the degradation chain for ``name`` (None at the
    bottom).  Paths outside the chain fall back to their declared
    ``fallback``, else to ``dense``."""
    if name in _DEGRADED_CHAIN:
        return _DEGRADED_CHAIN[name]
    return get_path(name).fallback or "dense"


def run_path(
    path: EvalPath, servable, literals: torch.Tensor, params: Params = ()
) -> torch.Tensor:
    """Class sums int32 [B, m]; ``literals`` must be in ``path.input_form``
    (which a sparse path's fallback shares).  ``params`` is a set from
    ``path.tunable``; ``()`` runs the path's defaults."""
    resolved = resolve_path(path, servable)
    if resolved is not path:
        # The params belong to the sparse path, not its dense twin: the
        # twin runs at its defaults.
        path, params = resolved, ()
    args = (
        literals,
        servable.include,
        servable.include_packed,
        servable.nonempty,
        servable.weights,
    )
    if path.needs_sparsity:
        args += (servable.sparsity,)
    with span("classify.clauses"):
        return path.fn(*args, **dict(params))


def run_path_raw(
    path: EvalPath, servable, raw: torch.Tensor, ingress: IngressSpec, params: Params = ()
) -> torch.Tensor:
    """Class sums int32 [B, m] straight from raw pixels: the path's
    ``ingress_fn`` in its literal form, then the path, all on ``raw``'s
    device."""
    if ingress.packed != (path.input_form == PACKED):
        ingress = dataclasses.replace(ingress, packed=path.input_form == PACKED)
    return run_path(path, servable, path.ingress_fn(ingress, raw), params)


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


@register_path("kernel", PACKED, tunable=_KERNEL_TUNABLE)
def _kernel(lits, include, include_packed, nonempty, weights, **params):
    fired = kops.clause_eval(lits, include_packed, nonempty, **params)
    return cl.class_sums(fired, weights)


@register_path("fused", PACKED, tunable=_KERNEL_TUNABLE)
def _fused(lits, include, include_packed, nonempty, weights, **params):
    return kops.fused_infer(lits, include_packed, nonempty, weights, **params)


# --- clause-sparsity paths (the active pool; see the module doc) -----------

@register_path("sparse", PACKED, needs_sparsity=True, fallback="bitpacked",
               tunable=_KERNEL_TUNABLE)
def _sparse(lits, include, include_packed, nonempty, weights, sparsity, **params):
    fired = kops.clause_eval_sparse(lits, sparsity.exclude_packed, **params)
    return cl.class_sums(fired, sparsity.weights)


@register_path("fused_sparse", PACKED, needs_sparsity=True, fallback="fused",
               tunable=_KERNEL_TUNABLE)
def _fused_sparse(lits, include, include_packed, nonempty, weights, sparsity, **params):
    return kops.fused_infer_sparse(lits, sparsity.exclude_packed, sparsity.weights,
                                   **params)


@register_path("matmul_sparse", DENSE, needs_sparsity=True, fallback="matmul")
def _matmul_sparse(lits, include, include_packed, nonempty, weights, sparsity):
    return kops.matmul_sparse_infer(lits, sparsity.include, sparsity.weights)
