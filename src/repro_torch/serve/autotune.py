"""Per-bucket evaluation-path autotuner (counterpart of ``repro/serve/autotune.py``).

For each (request form, bucket) the tuner times every admissible (eval
path, parameter set) candidate on zero inputs of exactly the shapes the
engine will dispatch, through the engine's own classify steps (the path,
the ingress for raw requests, and the argmax), and records the winner in
a :class:`TunedPlan`.  Which candidate wins depends on the geometry, the
clause pool and the device; the tuner measures instead of guessing.

Contract, as in the reference:

  * **Deterministic within a process.** Candidates are enumerated in
    sorted order; measurements are memoized on the full static key, so
    re-registering the same model gives the same plan; ties break on
    (path, params).
  * **Bit-identity is free.** Every candidate is a registered
    :class:`~repro_torch.serve.paths.EvalPath`, and every path and
    parameter set gives the same class sums, so the tuner never checks
    outputs.
  * **Hashable and serializable.** A :class:`TunedPlan` round-trips
    through JSON, byte for byte the reference's format, so a plan
    checkpoints beside the model.
  * **Admissibility.** Literal-form requests arrive in the registered
    path's input form, so only paths of that form compete; raw requests
    compete on every path.  A sparse path that would resolve to its dense
    fallback is left out (the fallback competes on its own).

Differences from the reference:

  * **When parameters are swept.** Non-default parameter sets
    (``block_c``, ``csrf``; see ``serve/paths.py``) are swept only where
    the CUDA kernels run, that is when the servable lies on a CUDA
    device.  On the CPU only ``()`` competes, as on the reference's CPU
    backend.  On a mesh only ``()`` competes either way, as in the
    reference: ``smesh`` measures through the meshed step the engine
    dispatches (``serve/mesh.py``), and the clause-sharded step takes no
    parameters.
  * **How a candidate is timed.** ``torch.cuda.synchronize(device)``
    around each call on the card, in place of ``jax.block_until_ready``;
    the best of ``repeats`` after one untimed warm call.
  * **The memo key** holds the device type, the device name, the
    ``ServeMesh`` (None unmeshed) and ``sparsity.n_active``, in place of
    the JAX backend.
  * **Foreign plans.** A plan measured on another device cannot be
    applied here; :func:`plan_applies` says whether a plan names only
    registered paths and their own parameter sets, and the checkpointer
    stamps a saved plan with the device it was measured on
    (``checkpoint/checkpointer.py``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ingress import IngressSpec, raw_trailing_shape
from repro_torch.serve import paths as sp
from repro_torch.serve.servable import ServableModel, servable_digest

__all__ = [
    "AutotuneReport",
    "TunedPlan",
    "autotune_servable",
    "clear_measure_memo",
    "device_name",
    "plan_applies",
]

#: ((name, value), ...) parameter sets; see paths.Params.
Params = sp.Params

FORMS = ("literals", "raw")


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The tuner's decisions: (form, bucket) -> (path, params).

    ``entries`` is a sorted tuple of ``(form, bucket, path_name, params)``,
    strings and ints only, so the plan is hashable (the measured times
    live in :class:`AutotuneReport`).  ``digest`` is the
    :func:`~repro_torch.serve.servable.servable_digest` of the image the
    plan was measured on; ``""`` means unstamped.
    """

    entries: Tuple[Tuple[str, int, str, Params], ...] = ()
    digest: str = ""

    def lookup(self, form: str, bucket: int) -> Optional[Tuple[str, Params]]:
        """The tuned (path, params) for a dispatch, or None if untuned.

        An exact (form, bucket) match first; otherwise the nearest tuned
        bucket of the form (the largest below, else the smallest above).
        """
        below, above = None, None
        for f, b, path, params in self.entries:
            if f != form:
                continue
            if b == bucket:
                return (path, params)
            if b < bucket and (below is None or b > below[0]):
                below = (b, path, params)
            if b > bucket and (above is None or b < above[0]):
                above = (b, path, params)
        pick = below or above
        return (pick[1], pick[2]) if pick else None

    def with_entry(self, form: str, bucket: int, path: str, params: Params) -> "TunedPlan":
        kept = tuple(e for e in self.entries if not (e[0] == form and e[1] == bucket))
        return TunedPlan(entries=tuple(sorted(kept + ((form, bucket, path, params),))),
                         digest=self.digest)

    def to_json(self) -> str:
        entries = [
            {"form": f, "bucket": b, "path": p, "params": [list(kv) for kv in ps]}
            for f, b, p, ps in self.entries
        ]
        if not self.digest:
            # Unstamped plans keep the reference's bare-list format.
            return json.dumps(entries)
        return json.dumps({"digest": self.digest, "entries": entries})

    @classmethod
    def from_json(cls, text: str) -> "TunedPlan":
        doc = json.loads(text)
        digest = ""
        if isinstance(doc, dict):        # stamped format
            digest = str(doc.get("digest", ""))
            doc = doc.get("entries", [])
        entries = tuple(sorted(
            (e["form"], int(e["bucket"]), e["path"],
             tuple((str(k), v) for k, v in e["params"]))
            for e in doc
        ))
        return cls(entries=entries, digest=digest)


def plan_applies(plan: TunedPlan) -> bool:
    """True iff every entry names a registered path and a parameter set
    from that path's ``tunable``: a plan this package can dispatch."""
    for _, _, name, params in plan.entries:
        if name not in sp.available_paths() or params not in sp.get_path(name).tunable:
            return False
    return True


def device_name(device: torch.device) -> str:
    """The name a plan measured on ``device`` is stamped with: the card's
    name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


@dataclasses.dataclass
class AutotuneReport:
    """Everything the tuner measured (one row per (form, bucket))."""

    rows: List[Dict] = dataclasses.field(default_factory=list)
    total_s: float = 0.0

    def as_dict(self) -> Dict:
        return {"rows": list(self.rows), "total_s": self.total_s}


# Seconds per call, memoized on the full static key so two registrations
# in one process give the same plan (wall clock jitters; the memo does
# not).  Across processes, TunedPlan's JSON carries a plan.
_MEASURE_MEMO: Dict[Tuple, float] = {}


def clear_measure_memo() -> None:
    """Drop memoized timings (tests re-measuring on purpose)."""
    _MEASURE_MEMO.clear()


def _zero_input(servable: ServableModel, path: sp.EvalPath, form: str, bucket: int,
                ingress: IngressSpec) -> np.ndarray:
    spec = servable.config.patch
    if form == "raw":
        return np.zeros((bucket,) + raw_trailing_shape(ingress), np.uint8)
    if path.input_form == sp.PACKED:
        return np.zeros((bucket, spec.n_patches, spec.n_words), np.uint32)
    return np.zeros((bucket, spec.n_patches, spec.n_literals), np.uint8)


def _candidates(servable: ServableModel, registered: sp.EvalPath, form: str, *,
                sweep_params: bool) -> List[Tuple[str, Params]]:
    """Sorted, deduplicated (path, params) candidates for one form."""
    out: List[Tuple[str, Params]] = []
    seen = set()
    for name in sp.available_paths():
        path = sp.get_path(name)
        if form == "literals" and path.input_form != registered.input_form:
            continue
        if sp.resolve_path(path, servable) is not path:
            continue    # would fall back: the fallback competes on its own
        for params in path.tunable if sweep_params else ((),):
            if (name, params) not in seen:
                seen.add((name, params))
                out.append((name, params))
    return sorted(out)


def _sweeps_params(device: torch.device) -> bool:
    """Non-default parameter sets are worth timing only where the CUDA
    kernels run; the plain versions ignore them."""
    return device.type == "cuda"


def _sync(devices: Sequence[torch.device]) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _time_candidate(step, devices: Sequence[torch.device], *, repeats: int) -> float:
    """Best of ``repeats`` seconds per call, after one untimed warm call;
    the cards are synchronised before and after each timed call."""
    step()
    best = float("inf")
    for _ in range(repeats):
        _sync(devices)
        t0 = time.perf_counter()
        step()
        _sync(devices)
        best = min(best, time.perf_counter() - t0)
    return best


def _measure(servable: ServableModel, name: str, params: Params, form: str, bucket: int,
             ingress: IngressSpec, *, repeats: int, smesh=None) -> float:
    """Seconds per engine classify step of one candidate on zero inputs of
    the bucket's shape, on the servable's device, or through the meshed
    step on ``smesh``."""
    # The engine's steps, imported here: the engine imports this module.
    from repro_torch.serve.engine import classify_raw_step, classify_step
    from repro_torch.serve.mesh import classify_step_meshed

    device = servable.include_packed.device
    arr = _zero_input(servable, sp.get_path(name), form, bucket, ingress)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)               # packed words: same bits
    if smesh is not None:
        xs = smesh.place_batch(arr)
        raw = ingress if form == "raw" else None
        step = lambda: classify_step_meshed(servable, xs, smesh, name, raw, params)  # noqa: E731
        return _time_candidate(step, smesh.distinct_devices, repeats=repeats)
    x = torch.from_numpy(arr).to(device)
    if form == "raw":
        step = lambda: classify_raw_step(servable, x, name, ingress, params)  # noqa: E731
    else:
        step = lambda: classify_step(servable, x, name, params)  # noqa: E731
    return _time_candidate(step, (device,), repeats=repeats)


def autotune_servable(
    servable: ServableModel,
    path_name: str,
    ingress: IngressSpec,
    buckets: Sequence[int],
    forms: Sequence[str] = FORMS,
    *,
    repeats: int = 3,
    max_seconds: Optional[float] = None,
    smesh=None,
) -> Tuple[TunedPlan, AutotuneReport]:
    """Time every admissible candidate per (form, bucket) on the servable's
    device; return the winning :class:`TunedPlan` and the full
    :class:`AutotuneReport`.

    ``smesh`` (a :class:`~repro_torch.serve.mesh.ServeMesh`, on which the
    servable is placed) measures through the meshed step the engine will
    dispatch, at default parameters only.

    ``max_seconds`` bounds the wall clock: once exceeded, the remaining
    candidates of a cell are skipped (the best so far wins; the report
    lists the skips).  Leave it None for reproducible plans.  A kernel's
    build or launch error is raised, never taken as a lost candidate.
    """
    device = servable.include_packed.device
    sweep = _sweeps_params(device) and smesh is None
    registered = sp.get_path(path_name)
    sparsity_key = None if servable.sparsity is None else servable.sparsity.n_active
    plan = servable.tuned or TunedPlan()
    report = AutotuneReport()
    t_start = time.perf_counter()
    budget_hit = False

    for form in forms:
        if form not in FORMS:
            raise ValueError(f"unknown autotune form {form!r} (use {FORMS})")
        for bucket in dict.fromkeys(int(b) for b in buckets):
            timed: List[Tuple[float, str, Params]] = []
            skipped = []
            for name, params in _candidates(servable, registered, form, sweep_params=sweep):
                if max_seconds is not None and time.perf_counter() - t_start > max_seconds:
                    budget_hit = True
                if budget_hit and timed:
                    skipped.append(name)
                    continue
                memo_key = (servable.config, device.type, device_name(device), smesh,
                            sparsity_key, form, bucket, name, params)
                if memo_key not in _MEASURE_MEMO:
                    _MEASURE_MEMO[memo_key] = _measure(servable, name, params, form, bucket,
                                                       ingress, repeats=repeats, smesh=smesh)
                timed.append((_MEASURE_MEMO[memo_key], name, params))
            if not timed:
                continue
            # Deterministic winner: least time, ties by (path, params).
            best_t, best_name, best_params = min(timed)
            plan = plan.with_entry(form, bucket, best_name, best_params)
            report.rows.append({
                "form": form,
                "bucket": bucket,
                "winner": best_name,
                "params": [list(kv) for kv in best_params],
                "us_per_call": best_t * 1e6,
                "candidates": [
                    {"path": n, "params": [list(kv) for kv in ps], "us_per_call": t * 1e6}
                    for t, n, ps in sorted(timed)
                ],
                "skipped": skipped,
            })
    report.total_s = time.perf_counter() - t_start
    # The plan is tuned for this register image: stamp its digest.
    return dataclasses.replace(plan, digest=servable_digest(servable)), report
