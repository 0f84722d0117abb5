"""Batched ConvCoTM serving engine (counterpart of ``repro/serve/engine.py``).

Models are frozen once into :class:`ServableModel` register images, moved
to the engine's device, and registered under a dataset key; raw uint8
pixel batches ``[n, Y, X]`` stream through the registered eval path.

One request slice on the card costs one H2D copy of the raw batch in,
from pinned host memory, and one D2H copy out, of predictions and class
sums packed into one int32 ``[bucket, 1 + m]`` tensor; booleanize,
patches, literals, packing, clause evaluation, class sums and argmax all
run on the card in between.  :meth:`ServingEngine.dispatch` returns an
:class:`InFlightClassify` without waiting; its ``result()`` waits on a
CUDA event recorded after the last copy.  Every launch and copy of a
request goes on the calling thread's current stream of the engine's
card (the default stream unless the caller sets another), so requests
dispatched from a worker thread and the transfers of a swap on a third
thread run in the order they were issued.

Request forms, as in the reference: raw pixels (the default, ingress on
the device), ``ingress='host'`` (the host pipeline
``data.pipeline.preprocess_for_serving``, then the literal-form step) and
``preprocessed=True`` (literals already in the path's input form: dense
uint8 ``[n, P, 2o]`` or packed uint32 ``[n, P, W]``).  The host route
equals the device route bit for bit.

Batch bucketing: requests are padded to the nearest power of two, clamped
to ``max_batch``; longer requests are served in ``max_batch`` slices.
Padding rows are zero images whose results are sliced off; no row can
affect another.  Buckets bound the set of shapes the kernels and the
caching allocator ever see, as they bound jit compiles in the reference;
``ServeStats.compiled_buckets`` lists the buckets run so far.

Lifecycle and faults, as in the reference: each registered model carries
a :class:`ServableVersion` stamp (the engine assigns the monotonic id;
epoch, step and digest come from the servable's own stamp when it has
one).  :meth:`ServingEngine.swap` installs new weights under live load
and :meth:`ServingEngine.rollback` restores the displaced image in O(1);
an engine lock (:meth:`ServingEngine.swap_guard`) pins one version across
every slice of a dispatch, and each :class:`InFlightClassify` holds the
image it was dispatched on until its result is read.
:meth:`ServingEngine.degrade_path` steps a model down the degradation
chain, and a ``faults`` plan (``serve/faults.py``) may fail a dispatch
before any work.

Autotuning, as in the reference (``serve/autotune.py``): an engine or a
registration armed with ``autotune`` measures every admissible (path,
params) candidate per (request form, bucket) at :meth:`ServingEngine.warmup`,
or when :meth:`ServingEngine.autotune` is called, and each dispatch then
runs its bucket's winner (:meth:`_Entry.resolve`).  The sweep runs
outside the engine lock, so a running service is not stalled for its
length; the plan is installed under the lock.  The plan rides on the
register image (``servable(name).tuned``), through swaps, rollbacks and
checkpoints.

Meshes, as in the reference (``serve/mesh.py``): an engine built with a
:class:`~repro_torch.serve.mesh.ServeMesh` (or a bare
:class:`~repro_torch.launch.mesh.DeviceMesh`, placed replicated) places
every registered image on the mesh, replicated or clause-sharded, and
splits every bucket over the mesh's data axis.  The shards are launched
on their devices one after the other, none waited on, and their results
land in their rows of one pinned host buffer; the handle's ``result()``
waits on one CUDA event per distinct device.  Buckets are clamped from
below to the data-axis size.  :meth:`ServingEngine.shrink_mesh` halves the
data axis after a device loss and re-places every image.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import clauses as cl
from repro_torch.core.cotm import CoTMConfig, CoTMModel
from repro_torch.core.ingress import IngressSpec, raw_trailing_shape
from repro_torch.data.pipeline import preprocess_for_serving
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.serve.autotune import TunedPlan, autotune_servable
from repro_torch.serve.mesh import ServeMesh, classify_step_meshed
from repro_torch.serve.paths import (
    PACKED,
    Params,
    degraded_fallback,
    get_path,
    resolve_path,
    run_path,
    run_path_raw,
)
from repro_torch.serve.servable import (
    ServableModel,
    ServableVersion,
    analyze_sparsity,
    freeze,
    servable_digest,
)
from repro_torch.spans import span

__all__ = [
    "ClassifyResult",
    "InFlightClassify",
    "ServeStats",
    "ServingEngine",
    "classify_raw_step",
    "classify_step",
]

#: The request forms a bucket is run in.
FORMS = ("literals", "raw")


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


@dataclasses.dataclass
class ClassifyResult:
    """One request's outcome."""

    predictions: np.ndarray   # int32 [n]
    class_sums: np.ndarray    # int32 [n, m]
    latency_s: float          # wall clock incl. ingress
    bucket: int               # largest padded batch size executed
    ingress_s: float = 0.0    # host-side validation share
    device_s: float = 0.0     # dispatch -> results on the host share
    version: int = 0          # monotonic id of the version that computed it


@dataclasses.dataclass
class ServeStats:
    """Running per-model accounting.  ``devices`` is the mesh size the
    model serves on (1 unmeshed) and ``data_shards`` its batch shards;
    buckets are global batch sizes, and on a mesh each data shard runs
    ``bucket // data_shards`` rows (:attr:`per_device_bucket_hits`).
    ``autotune`` holds the last tuning pass (``rows``, ``total_s``,
    ``plan``; empty when the model was not tuned here); ``fallback_path``
    and ``degrade_steps`` record the degradation chain."""

    requests: int = 0
    images: int = 0
    total_latency_s: float = 0.0
    ingress_s: float = 0.0
    device_s: float = 0.0
    bucket_hits: Dict[int, int] = dataclasses.field(default_factory=dict)
    compiled_buckets: Tuple[int, ...] = ()
    devices: int = 1
    data_shards: int = 1
    autotune: Dict = dataclasses.field(default_factory=dict)
    fallback_path: Optional[str] = None
    degrade_steps: int = 0

    @property
    def classifications_per_s(self) -> float:
        return self.images / self.total_latency_s if self.total_latency_s else 0.0

    @property
    def mean_latency_us(self) -> float:
        return self.total_latency_s / self.requests * 1e6 if self.requests else 0.0

    @property
    def mean_ingress_us(self) -> float:
        return self.ingress_s / self.requests * 1e6 if self.requests else 0.0

    @property
    def mean_device_us(self) -> float:
        return self.device_s / self.requests * 1e6 if self.requests else 0.0

    @property
    def per_device_bucket_hits(self) -> Dict[int, int]:
        """Bucket hits keyed by the rows each device executed."""
        return {b // self.data_shards: h for b, h in self.bucket_hits.items()}

    def as_dict(self) -> Dict:
        return {
            "requests": self.requests,
            "images": self.images,
            "classifications_per_s": self.classifications_per_s,
            "mean_latency_us": self.mean_latency_us,
            "mean_ingress_us": self.mean_ingress_us,
            "mean_device_us": self.mean_device_us,
            "bucket_hits": dict(self.bucket_hits),
            "compiled_buckets": list(self.compiled_buckets),
            "devices": self.devices,
            "data_shards": self.data_shards,
            "per_device_bucket_hits": dict(self.per_device_bucket_hits),
            "autotune": dict(self.autotune),
            "fallback_path": self.fallback_path,
            "degrade_steps": self.degrade_steps,
        }


@dataclasses.dataclass
class _Entry:
    servable: ServableModel
    booleanize_method: str
    booleanize_kw: Dict
    path_name: str
    ingress: IngressSpec
    stats: ServeStats
    version: ServableVersion
    # (form, bucket) pairs run on this image; reset when the image changes.
    compiled: set = dataclasses.field(default_factory=set)
    # The image and stamp a swap displaced, kept whole for rollback().
    previous: Optional[Tuple[ServableModel, ServableVersion]] = None
    # The stamped image servable() hands out, until the entry changes.
    stamped: Optional[ServableModel] = None
    # Armed for the autotuner: warmup tunes the image once.
    autotune: bool = False

    def resolve(self, form: str, bucket: int) -> Tuple[str, Params]:
        """The (path, params) this entry dispatches for a (form, bucket):
        the tuned winner when the image's plan covers it, else the
        registered path at its defaults."""
        plan = self.servable.tuned
        if plan is not None:
            hit = plan.lookup(form, bucket)
            if hit is not None:
                return hit
        return self.path_name, ()


def _packed_result(v: torch.Tensor) -> torch.Tensor:
    with span("classify.argmax"):
        return torch.cat([cl.argmax_predict(v)[:, None], v], dim=1)


@torch.inference_mode()
def classify_step(servable: ServableModel, x: torch.Tensor, path_name: str,
                  params: Params = ()) -> torch.Tensor:
    """The literal-form classify step: ``path_name`` at ``params`` on
    literals ``x`` in its input form, then the argmax; int32 ``[B, 1 + m]``
    (predictions, class sums), on ``x``'s device, without waiting."""
    return _packed_result(run_path(get_path(path_name), servable, x, params))


@torch.inference_mode()
def classify_raw_step(servable: ServableModel, raw: torch.Tensor, path_name: str,
                      ingress: IngressSpec, params: Params = ()) -> torch.Tensor:
    """The raw-form classify step: the path's ingress, ``path_name`` at
    ``params`` and the argmax; int32 ``[B, 1 + m]``, without waiting."""
    return _packed_result(run_path_raw(get_path(path_name), servable, raw, ingress, params))


class InFlightClassify:
    """A dispatched request whose device work may still be running.

    ``result()`` waits for the devices, slices off the bucket padding,
    records the request's stats and returns the :class:`ClassifyResult`;
    it is idempotent.  Until then it holds the register image it was
    dispatched on, so a swap cannot free tensors that queued kernels read.
    ``done`` holds one CUDA event per distinct card the request ran on
    (empty on the CPU, where the work is complete at dispatch): on a mesh
    of several cards one event would not say that another card's rows have
    reached the host buffer.
    """

    def __init__(self, entry: _Entry, parts, n: int, t0: float, t_dispatch: float,
                 done: Tuple[torch.cuda.Event, ...] = (), version: int = 0,
                 servable: Optional[ServableModel] = None):
        self._entry = entry
        self._parts = parts            # [(host int32 [bucket, 1 + m], n_i, bucket)]
        self._n = n
        self._t0 = t0
        self._t_dispatch = t_dispatch
        self._done = done
        # Version id captured under the engine lock at dispatch.
        self.version = version
        self._servable = servable
        self._result: Optional[ClassifyResult] = None

    def result(self) -> ClassifyResult:
        if self._result is not None:
            return self._result
        with span("engine.result"):
            with span("engine.wait"):
                for event in self._done:
                    event.synchronize()
            self._servable = None
            t2 = time.perf_counter()
            with span("engine.unpack"):
                out = np.concatenate([h.numpy()[:ni] for h, ni, _ in self._parts])
                ingress_s = self._t_dispatch - self._t0
                device_s = t2 - self._t_dispatch
                st = self._entry.stats
                st.requests += 1
                st.images += self._n
                st.total_latency_s += t2 - self._t0
                st.ingress_s += ingress_s
                st.device_s += device_s
                self._result = ClassifyResult(
                    predictions=np.ascontiguousarray(out[:, 0]),
                    class_sums=np.ascontiguousarray(out[:, 1:]),
                    latency_s=t2 - self._t0,
                    bucket=max(b for _, _, b in self._parts),
                    ingress_s=ingress_s,
                    device_s=device_s,
                    version=self.version,
                )
        return self._result


class ServingEngine:
    """Multi-model batched classification on one device or a device mesh.

    ``device``: where the register images live and the classify steps run;
    by default the current CUDA card, and with no card a ``RuntimeError``
    (pass ``device="cpu"`` to run the plain versions on the CPU).
    ``mesh`` (a :class:`~repro_torch.serve.mesh.ServeMesh`, or a bare
    :class:`~repro_torch.launch.mesh.DeviceMesh` taken as a replicated
    ServeMesh) serves every model across the mesh (see ``serve/mesh.py``);
    ``device`` is then the mesh's first device.  The data-axis size must be
    a power of two <= ``max_batch``, so every power-of-two bucket splits
    evenly.  ``faults``: an optional
    :class:`~repro_torch.serve.faults.FaultPlan` whose ``on_engine_dispatch``
    runs at the top of every dispatch (chaos tests).  ``autotune`` arms
    every registration for the autotuner by default; ``autotune_repeats``
    and ``autotune_max_seconds`` are its timing repeats and wall-clock
    budget.
    """

    def __init__(self, max_batch: int = 256, *, mesh=None, device=None, faults=None,
                 autotune: bool = False, autotune_repeats: int = 3,
                 autotune_max_seconds: Optional[float] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if isinstance(mesh, DeviceMesh):
            mesh = ServeMesh(mesh)
        if mesh is not None:
            if not isinstance(mesh, ServeMesh):
                raise TypeError(f"mesh must be a ServeMesh or a DeviceMesh; got "
                                f"{type(mesh).__name__}")
            nd = mesh.n_data
            if nd & (nd - 1):
                raise ValueError(f'"data" axis size {nd} must be a power of two so pow2 '
                                 f"buckets split evenly")
            if nd > max_batch:
                raise ValueError(f'"data" axis size {nd} exceeds max_batch={max_batch}')
            if device is not None and resolve_device(device) != mesh.first_device:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.first_device}")
            device = mesh.first_device
        self.max_batch = max_batch
        self.mesh: Optional[ServeMesh] = mesh
        self.device = resolve_device(device)
        self.faults = faults
        self.autotune_default = autotune
        self.autotune_repeats = autotune_repeats
        self.autotune_max_seconds = autotune_max_seconds
        self._servables: Dict[str, _Entry] = {}
        # Serialises entry changes (swap, rollback, degrade) against
        # dispatch, which captures (image, version) under it.  Re-entrant,
        # so the service can pin one version across a multi-form
        # microbatch (swap_guard) around its own dispatch calls.
        self._lock = threading.RLock()

    @property
    def devices(self) -> int:
        """Mesh size (1 for the single-device engine)."""
        return 1 if self.mesh is None else self.mesh.devices

    @property
    def data_shards(self) -> int:
        """Batch shards per dispatched bucket (the "data" axis size)."""
        return 1 if self.mesh is None else self.mesh.n_data

    def _cards(self) -> Tuple[torch.device, ...]:
        """The distinct CUDA devices the engine's work runs on."""
        devs = (self.device,) if self.mesh is None else self.mesh.distinct_devices
        return tuple(d for d in devs if d.type == "cuda")

    def _place(self, servable: ServableModel) -> ServableModel:
        """The dispatch image: placed on the mesh, or moved to the device."""
        if self.mesh is not None:
            return self.mesh.place_servable(servable)
        return servable.to(self.device)

    # --- registry ---------------------------------------------------------

    @staticmethod
    def _stamp(servable: ServableModel, source: Optional[ServableVersion]) -> ServableVersion:
        """Epoch, step and digest from ``source`` (the digest is computed
        when ``source`` has none); the caller sets the monotonic id under
        the engine lock."""
        return ServableVersion(
            epoch=source.epoch if source else 0,
            step=source.step if source else 0,
            digest=source.digest if source and source.digest else servable_digest(servable),
        )

    def _next_version_id(self, name: str) -> int:
        prev = self._servables.get(name)
        return prev.version.version + 1 if prev is not None else 1

    def register(
        self,
        name: str,
        model: CoTMModel | ServableModel,
        config: Optional[CoTMConfig] = None,
        *,
        booleanize_method: str = "threshold",
        path: Optional[str] = None,
        booleanize_kw: Optional[Dict] = None,
        version: Optional[ServableVersion] = None,
        autotune: Optional[bool] = None,
        tuned: Optional[TunedPlan] = None,
    ) -> ServableModel:
        """Freeze (if needed), attach the sparsity image
        (:func:`analyze_sparsity`; not on a clause-sharded mesh), move to
        the engine's device or place on its mesh once, and register a model
        under a dataset key.  ``path`` defaults to the
        config's ``eval_path``; ``booleanize_kw`` (``threshold``,
        ``block_size``, ``c``, ``levels``) sets the ingress knobs of both
        request routes.  ``version`` (or the servable's own stamp) gives
        epoch, step and digest; the id is the slot's next.  ``autotune``
        (default: the engine's flag) arms the autotuner, which runs at
        :meth:`warmup` or :meth:`autotune`, never per request; ``tuned``
        attaches a measured plan (from a checkpoint, say) without
        re-measuring.  A ``ServableModel`` given here is copied, not moved:
        ``nn.Module.to`` works in place, and the caller's image stays where
        it was.  The dispatched image carries no stamp; :meth:`servable`
        adds it."""
        if isinstance(model, ServableModel):
            servable = copy.deepcopy(model.replace(placement=None))
        else:
            if config is None:
                raise ValueError("config required when registering a CoTMModel")
            servable = freeze(model, config)
        path_name = path or servable.config.eval_path
        eval_path = get_path(path_name)
        booleanize_kw = dict(booleanize_kw or {})
        ingress = eval_path.ingress_spec(servable.config.patch, method=booleanize_method,
                                         **booleanize_kw)
        source = version if version is not None else servable.version
        # Sparsity analysis is skipped on clause-sharded meshes: the active
        # set is not shard-uniform, and placement drops it.
        if self.mesh is None or not self.mesh.shard_clauses:
            servable = analyze_sparsity(servable)
        if tuned is not None:
            servable = servable.replace(tuned=tuned)
        stamp = self._stamp(servable, source)
        servable = self._place(servable.replace(version=None))
        with self._lock:
            self._servables[name] = _Entry(
                servable=servable,
                booleanize_method=booleanize_method,
                booleanize_kw=booleanize_kw,
                path_name=path_name,
                ingress=ingress,
                stats=ServeStats(devices=self.devices, data_shards=self.data_shards),
                version=dataclasses.replace(stamp, version=self._next_version_id(name)),
                autotune=self.autotune_default if autotune is None else autotune,
            )
        return servable

    def load_checkpoint(
        self,
        name: str,
        directory: str,
        config: CoTMConfig,
        *,
        step: Optional[int] = None,
        booleanize_method: str = "threshold",
        path: Optional[str] = None,
    ) -> ServableModel:
        """Restore a model from a checkpoint directory (written by either
        package) and register it.  Both flavours: a ``CoTMModel`` tree from
        the trainer, or a register image from ``save_servable`` (the
        lifecycle's promote); the manifest's leaf names tell them apart.
        A tuned plan in the manifest is applied only when it was measured
        on this engine's device (``checkpointer.plan_from_extra``); a
        foreign one is dropped, and an armed engine re-tunes at warmup."""
        from repro_torch.checkpoint.checkpointer import (
            latest_step,
            plan_from_extra,
            restore_pytree,
            restore_servable,
        )

        resolved = latest_step(directory) if step is None else step
        if resolved is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
        manifest = os.path.join(directory, f"step_{resolved:08d}", "manifest.json")
        with open(manifest) as f:
            leaves = json.load(f).get("leaves", {})
        if "include" in leaves and ".ta_state" not in leaves:
            # The stamp and the plan ride on the image itself.
            servable, _ = restore_servable(config, directory, resolved, device=self.device)
            return self.register(name, servable, booleanize_method=booleanize_method,
                                 path=path)
        template = CoTMModel(
            ta_state=torch.zeros((config.n_clauses, config.n_literals), dtype=torch.uint8),
            weights=torch.zeros((config.n_classes, config.n_clauses), dtype=torch.int32),
        )
        model, _, extra = restore_pytree(template, directory, resolved, device="cpu")
        extra = extra or {}
        stamp = ServableVersion.from_dict(extra.get("servable_version"))
        return self.register(
            name, model, config, booleanize_method=booleanize_method, path=path,
            tuned=plan_from_extra(extra, self.device),
            version=stamp if stamp != ServableVersion() else None,
        )

    def models(self) -> Tuple[str, ...]:
        return tuple(sorted(self._servables))

    def servable(self, name: str) -> ServableModel:
        """The register image being served, stamped with the live
        :class:`ServableVersion` (the dispatched image carries none);
        repeated reads of one install return the same object."""
        with self._lock:
            entry = self._servables[name]
            if entry.stamped is None:
                entry.stamped = entry.servable.replace(version=entry.version)
            return entry.stamped

    def ingress_spec(self, name: str) -> IngressSpec:
        return self._servables[name].ingress

    def version(self, name: str) -> ServableVersion:
        """The stamp of the model served under ``name``."""
        return self._servables[name].version

    def version_id(self, name: str) -> int:
        """Monotonic id of the version served under ``name``."""
        return self._servables[name].version.version

    def stats(self, name: str) -> ServeStats:
        return self._servables[name].stats

    def resolved_path(self, name: str) -> str:
        """The path a dispatch of ``name`` really evaluates when no tuned
        plan covers its bucket: the registered path, or its dense fallback
        when the servable carries no sparsity image (a tuned bucket runs
        its winner: ``servable(name).tuned``)."""
        entry = self._servables[name]
        return resolve_path(get_path(entry.path_name), entry.servable).name

    # --- lifecycle --------------------------------------------------------

    def swap_guard(self):
        """The engine lock, for callers that pin one version across several
        ``dispatch`` calls (re-entrant with dispatch's own locking)."""
        return self._lock

    def swap(
        self,
        name: str,
        model: CoTMModel | ServableModel,
        config: Optional[CoTMConfig] = None,
        *,
        version: Optional[ServableVersion] = None,
        tuned: Optional[TunedPlan] = None,
        retune: bool = False,
    ) -> ServableVersion:
        """Replace ``name``'s weights under live load; returns the new stamp.

        The new image keeps the slot's eval path, ingress and booleanize
        knobs; its config must equal the live one.  It is frozen, analysed
        (sparsity padded to the pow2 bin, so versions share shapes) and
        moved to the device before the lock is taken; the install itself
        is a pointer swap.  Dispatches already made complete on the old
        image, which their handles hold; the displaced image is kept
        whole for :meth:`rollback`.  ``tuned`` pins a plan measured for the
        candidate; by default the live one is carried over (its digest
        marks it as tuned for a prior version); ``retune`` re-measures on
        the candidate after the install.
        """
        entry = self._servables[name]
        if isinstance(model, ServableModel):
            candidate = copy.deepcopy(model.replace(placement=None))
        else:
            if config is None:
                raise ValueError("config required when swapping in a CoTMModel")
            candidate = freeze(model, config)
        live_cfg = entry.servable.config
        if candidate.config != live_cfg:
            raise ValueError(
                f"swap({name!r}) config mismatch: a swap replaces weights only; got "
                f"{candidate.config!r}, serving {live_cfg!r} (re-register for a "
                f"geometry change)"
            )
        source = version if version is not None else candidate.version
        candidate = candidate.replace(sparsity=None)
        if self.mesh is None or not self.mesh.shard_clauses:
            candidate = analyze_sparsity(candidate, pad_to="pow2")
        stamp = self._stamp(candidate, source)
        carried = entry.servable.tuned if tuned is None and not retune else tuned
        candidate = self._place(candidate.replace(tuned=carried, version=None))
        with self._lock:
            stamp = dataclasses.replace(stamp, version=entry.version.version + 1)
            entry.previous = (entry.servable, entry.version)
            entry.servable = candidate
            entry.version = stamp
            entry.compiled = set()
            entry.stamped = None
        if retune:
            self.autotune(name)
        return stamp

    def rollback(self, name: str) -> ServableVersion:
        """Restore the image the last swap displaced, in O(1): no freeze,
        no analysis, no transfer; its tuned plan rides on it.  The restored
        weights get a fresh id with the prior stamp's epoch, step and
        digest; a second rollback flips back."""
        entry = self._servables[name]
        with self._lock:
            if entry.previous is None:
                raise ValueError(f"rollback({name!r}): no previous version (nothing was "
                                 f"swapped)")
            prev_servable, prev_stamp = entry.previous
            entry.previous = (entry.servable, entry.version)
            entry.servable = prev_servable
            entry.version = dataclasses.replace(prev_stamp,
                                                version=entry.version.version + 1)
            entry.compiled = set()
            entry.stamped = None
            return entry.version

    def degrade_path(self, name: str) -> Optional[str]:
        """Move ``name`` one step down the degradation chain
        (:func:`~repro_torch.serve.paths.degraded_fallback`: sparse -> dense
        twin, fused -> matmul, ... -> dense), rebuilding its ingress for
        the fallback's literal form and dropping its tuned plan.  Results
        stay bit-identical.  Returns the new path, or None at the bottom."""
        entry = self._servables[name]
        with self._lock:
            nxt = degraded_fallback(entry.path_name)
            if nxt is None:
                return None
            entry.path_name = nxt
            entry.ingress = get_path(nxt).ingress_spec(
                entry.servable.config.patch, method=entry.booleanize_method,
                **entry.booleanize_kw)
            entry.servable = entry.servable.replace(tuned=None)
            entry.compiled = set()
            entry.stamped = None
            entry.stats.fallback_path = nxt
            entry.stats.degrade_steps += 1
            return nxt

    def shrink_mesh(self) -> Optional[ServeMesh]:
        """Re-place every registered image on a shrunk mesh after a device
        loss on the data axis.

        Halves the batch shards (the model axis is kept: clause shards hold
        model state, the data axis only request rows) and re-places each
        entry's image, and the image a swap displaced, with
        ``ServeMesh.place_servable``: copies of the register image, no
        re-freeze, no sparsity analysis.  Dispatches already made hold
        their images and complete on the old mesh; the engine lock makes
        the cutover atomic, as for :meth:`swap`.  Bucket warmth resets.
        Returns the new mesh, or None when there is nothing to shrink
        (unmeshed, or a data axis of 1)."""
        with self._lock:
            if self.mesh is None:
                return None
            new = self.mesh.shrunk()
            if new is None:
                return None
            self.mesh = new
            for entry in self._servables.values():
                entry.servable = new.place_servable(entry.servable)
                if entry.previous is not None:
                    prev, stamp = entry.previous
                    entry.previous = (new.place_servable(prev), stamp)
                entry.compiled = set()
                entry.stamped = None
                entry.stats.devices = new.devices
                entry.stats.data_shards = new.n_data
            return new

    # --- serving ----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest power of two >= n, clamped to ``max_batch``, and on a
        mesh clamped from below to the data-axis size, so every padded
        bucket splits evenly over the batch shards."""
        if n < 1:
            raise ValueError("empty request")
        return max(min(1 << (n - 1).bit_length(), self.max_batch), self.data_shards)

    def autotune(self, name: str, buckets=None, *, forms=FORMS,
                 repeats: Optional[int] = None,
                 max_seconds: Optional[float] = None) -> TunedPlan:
        """Measure the eval-path candidates per (form, bucket) and pin the
        winners on ``name``'s image (see ``serve/autotune.py``).

        Default buckets: ``bucket_for(1)`` and ``max_batch``; a bucket in
        between takes its nearest tuned neighbour's winner.  The sweep runs
        outside the engine lock, on the image live when it starts; the plan
        is installed under the lock, on that image only (a swap meanwhile
        keeps its own plan).  On a mesh the sweep times the meshed steps
        at default parameters only.  The report and the plan land in
        ``stats(name).autotune``; the plan also rides on
        ``servable(name).tuned``.
        """
        entry = self._servables[name]
        if buckets is None:
            buckets = dict.fromkeys((self.bucket_for(1), self.max_batch))
        buckets = [self.bucket_for(int(b)) for b in buckets]
        with self._lock:
            # The image and the mesh it is placed on, together (a shrink
            # meanwhile re-places the entry; the plan then is not installed).
            measured, path_name, ingress = entry.servable, entry.path_name, entry.ingress
            smesh = self.mesh
        plan, report = autotune_servable(
            measured, path_name, ingress, buckets, forms,
            repeats=self.autotune_repeats if repeats is None else repeats,
            max_seconds=self.autotune_max_seconds if max_seconds is None else max_seconds,
            smesh=smesh,
        )
        with self._lock:
            if entry.servable is measured:
                entry.servable = measured.replace(tuned=plan)
                entry.compiled = set()       # warmup runs the tuned paths
                entry.stamped = None
        entry.stats.autotune = {**report.as_dict(), "plan": [list(e) for e in plan.entries]}
        return plan

    def warmup(self, name: str, buckets=None, *, forms=FORMS) -> Tuple[int, ...]:
        """Run one zero batch per bucket and form (default: every power of
        two up to ``max_batch``, raw and literals), so the kernels are
        built and loaded and the allocators hold every bucket's buffers
        before the first request.  Request statistics stay untouched.
        A model armed with ``autotune`` and not yet tuned is tuned first,
        once, outside the lock, so each bucket warms its tuned path.
        Returns the buckets newly run."""
        entry = self._servables[name]
        if unknown := set(forms) - set(FORMS):
            raise ValueError(f"unknown warmup forms: {sorted(unknown)}")
        if entry.autotune and entry.servable.tuned is None:
            self.autotune(name, forms=forms)
        if buckets is None:
            buckets = [1 << i for i in range(self.max_batch.bit_length())
                       if 1 << i < self.max_batch] + [self.max_batch]
        for b in buckets:
            if not 1 <= b <= self.max_batch:
                raise ValueError(f"warmup bucket {b} outside [1, max_batch={self.max_batch}]")
        warmed = []
        with self._lock:
            for b in dict.fromkeys(self.bucket_for(b) for b in buckets):
                fresh = [f for f in forms if (f, b) not in entry.compiled]
                for form in fresh:
                    zeros = (self._zero_raw(entry, b) if form == "raw"
                             else self._zero_literals(entry, b))
                    self._submit_bucket(entry, zeros, form=form, record_hit=False)
                if fresh:
                    warmed.append(b)
        for card in self._cards():
            torch.cuda.synchronize(card)
        return tuple(warmed)

    def _zero_literals(self, entry: _Entry, b: int) -> np.ndarray:
        spec = entry.servable.config.patch
        if get_path(entry.path_name).input_form == PACKED:
            return np.zeros((b, spec.n_patches, spec.n_words), np.uint32)
        return np.zeros((b, spec.n_patches, spec.n_literals), np.uint8)

    def _zero_raw(self, entry: _Entry, b: int) -> np.ndarray:
        return np.zeros((b,) + raw_trailing_shape(entry.ingress), np.uint8)

    @torch.inference_mode()
    def _submit_bucket(self, entry: _Entry, arr: np.ndarray, record_hit: bool = True,
                       form: str = "raw"):
        """Pad one <= max_batch slice to its bucket and run the classify
        step of the bucket's tuned path, or of the registered path (raw
        pixels, or literals in the registered path's form, which a tuned
        literal-form winner shares), without waiting; returns
        ``(host_out, n, bucket)``, where ``host_out`` is int32
        ``[bucket, 1 + m]`` (predictions, class sums) that is complete once
        the devices have caught up.  On a mesh every data shard is launched
        before any copy back, and each copies into its own rows of
        ``host_out``.  Callers hold the engine lock."""
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)          # packed words: same bits
        n = arr.shape[0]
        bucket = self.bucket_for(n)
        on_card = self.device.type == "cuda"
        with span("engine.stage_in"):
            host = torch.empty((bucket,) + arr.shape[1:], dtype=_torch_dtype(arr.dtype),
                               pin_memory=on_card)
            buf = host.numpy()
            buf[:n] = arr
            buf[n:] = 0
            x = (self.mesh.place_batch(host) if self.mesh is not None
                 else host.to(self.device, non_blocking=True))
        path_name, params = entry.resolve(form, bucket)
        ingress = entry.ingress if form == "raw" else None
        if self.mesh is not None:
            outs = classify_step_meshed(entry.servable, x, self.mesh, path_name, ingress, params)
        elif ingress is not None:
            outs = [classify_raw_step(entry.servable, x, path_name, ingress, params)]
        else:
            outs = [classify_step(entry.servable, x, path_name, params)]
        with span("engine.stage_out"):
            if on_card:
                host_out = torch.empty((bucket, outs[0].shape[1]), dtype=torch.int32,
                                       pin_memory=True)
                rows = bucket // len(outs)
                for d, out in enumerate(outs):
                    host_out[d * rows:(d + 1) * rows].copy_(out, non_blocking=True)
            else:
                host_out = outs[0] if len(outs) == 1 else torch.cat(outs)
        st = entry.stats
        if record_hit:
            st.bucket_hits[bucket] = st.bucket_hits.get(bucket, 0) + 1
        entry.compiled.add((form, bucket))
        if bucket not in st.compiled_buckets:
            st.compiled_buckets = st.compiled_buckets + (bucket,)
        return host_out, n, bucket

    def validate_raw(self, name: str, raw_images) -> np.ndarray:
        """Check a raw pixel batch against the model's ingress geometry;
        returns it as an ndarray."""
        entry = self._servables[name]
        raw = np.asarray(raw_images)
        if len(raw) == 0:
            raise ValueError("empty request")
        want = raw_trailing_shape(entry.ingress)
        if raw.shape[1:] != want:
            raise ValueError(
                f"raw images for {name!r} must be [n, {', '.join(map(str, want))}] "
                f"(method={entry.booleanize_method!r}); got {list(raw.shape)}"
            )
        return raw

    def _validate_preprocessed(self, lits: np.ndarray, entry: _Entry) -> None:
        """Refuse literals that are not in the path's input form: dense
        uint8 ``[n, P, 2o]`` or packed uint32 ``[n, P, W]``."""
        spec = entry.servable.config.patch
        if get_path(entry.path_name).input_form == PACKED:
            want = (np.uint32, (spec.n_patches, spec.n_words),
                    f"packed uint32 [n, P={spec.n_patches}, W={spec.n_words}]")
        else:
            want = (np.uint8, (spec.n_patches, spec.n_literals),
                    f"dense uint8 [n, P={spec.n_patches}, 2o={spec.n_literals}]")
        if lits.ndim != 3 or lits.shape[1:] != want[1] or lits.dtype != want[0]:
            raise ValueError(
                f"preprocessed literals for eval path {entry.path_name!r} must be "
                f"{want[2]}; got {lits.dtype} {list(lits.shape)} (use "
                f"data.pipeline.preprocess_for_serving(..., packed="
                f"{get_path(entry.path_name).input_form == PACKED}))"
            )

    def preprocess(self, name: str, raw_images, *, preprocessed: bool = False) -> np.ndarray:
        """The host-side ingress of a registered model: literals in its
        path's input form (with ``preprocessed``, the input is only
        checked against that form)."""
        entry = self._servables[name]
        if len(raw_images) == 0:
            raise ValueError("empty request")
        if preprocessed:
            lits = np.asarray(raw_images)
            self._validate_preprocessed(lits, entry)
            return lits
        return preprocess_for_serving(
            raw_images, entry.servable.config.patch, method=entry.booleanize_method,
            packed=get_path(entry.path_name).input_form == PACKED, **entry.booleanize_kw,
        )

    def dispatch(self, name: str, images, *, preprocessed: bool = False,
                 ingress: str = "device") -> InFlightClassify:
        """Submit one request batch and return without waiting on the
        device: raw pixels (ingress on the device, or ``ingress='host'``),
        or with ``preprocessed`` literals in the path's input form.
        Requests over ``max_batch`` go in ``max_batch`` slices, all on the
        one version captured under the engine lock."""
        if ingress not in ("device", "host"):
            raise ValueError(f"ingress must be 'device' or 'host', got {ingress!r}")
        entry = self._servables[name]
        if self.faults is not None:
            # Chaos seam: may raise before any host or device work.
            self.faults.on_engine_dispatch(name)
        with span("engine.dispatch"):
            t0 = time.perf_counter()
            if preprocessed or ingress == "host":
                arr = self.preprocess(name, images, preprocessed=preprocessed)
                form = "literals"
            else:
                arr = self.validate_raw(name, images)
                form = "raw"
            t1 = time.perf_counter()
            n = arr.shape[0]
            with self._lock:
                ver, servable = entry.version.version, entry.servable
                parts: List = [
                    self._submit_bucket(entry, arr[i : i + self.max_batch], form=form)
                    for i in range(0, n, self.max_batch)
                ]
                # One event per distinct card, after that card's copies back.
                done = []
                with span("engine.stage_out"):
                    for card in self._cards():
                        done.append(torch.cuda.Event())
                        done[-1].record(torch.cuda.current_stream(card))
            return InFlightClassify(entry, parts, n, t0, t1, tuple(done), version=ver,
                                    servable=servable)

    def classify(self, name: str, images, *, preprocessed: bool = False,
                 ingress: str = "device") -> ClassifyResult:
        """Classify one request batch (``dispatch(...).result()``)."""
        return self.dispatch(name, images, preprocessed=preprocessed,
                             ingress=ingress).result()
