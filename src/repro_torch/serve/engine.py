"""Batched ConvCoTM serving engine (core of ``repro/serve/engine.py``).

Models are frozen once into :class:`ServableModel` register images, moved
to the engine's device, and registered under a dataset key; raw uint8
pixel batches ``[n, Y, X]`` stream through the registered eval path.

One request slice on the card costs one H2D copy of the raw batch in,
from pinned host memory, and one D2H copy out, of predictions and class
sums packed into one int32 ``[bucket, 1 + m]`` tensor; booleanize,
patches, literals, packing, clause evaluation, class sums and argmax all
run on the card in between.  :meth:`ServingEngine.dispatch` returns an
:class:`InFlightClassify` without waiting; its ``result()`` waits on a
CUDA event recorded after the last copy.

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
caching allocator ever see, as they bound jit compiles in the reference.

Each registered model carries a :class:`ServableVersion` stamp (the
engine assigns the monotonic id; epoch, step and digest come from the
servable's own stamp when it has one).  Autotuning, meshes, fault
injection and hot swap are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import clauses as cl
from repro_torch.core.cotm import CoTMConfig, CoTMModel
from repro_torch.core.ingress import IngressSpec, raw_trailing_shape
from repro_torch.data.pipeline import preprocess_for_serving
from repro_torch.serve.paths import PACKED, get_path, resolve_path, run_path, run_path_raw
from repro_torch.serve.servable import (
    ServableModel,
    ServableVersion,
    analyze_sparsity,
    freeze,
    servable_digest,
)

__all__ = ["ClassifyResult", "InFlightClassify", "ServeStats", "ServingEngine"]


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


@dataclasses.dataclass
class ServeStats:
    """Running per-model accounting."""

    requests: int = 0
    images: int = 0
    total_latency_s: float = 0.0
    ingress_s: float = 0.0
    device_s: float = 0.0
    bucket_hits: Dict[int, int] = dataclasses.field(default_factory=dict)

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

    def as_dict(self) -> Dict:
        return {
            "requests": self.requests,
            "images": self.images,
            "classifications_per_s": self.classifications_per_s,
            "mean_latency_us": self.mean_latency_us,
            "mean_ingress_us": self.mean_ingress_us,
            "mean_device_us": self.mean_device_us,
            "bucket_hits": dict(self.bucket_hits),
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


class InFlightClassify:
    """A dispatched request whose device work may still be running.

    ``result()`` waits for the device, slices off the bucket padding,
    records the request's stats and returns the :class:`ClassifyResult`;
    it is idempotent.
    """

    def __init__(self, entry: _Entry, parts, n: int, t0: float, t_dispatch: float,
                 done: Optional[torch.cuda.Event]):
        self._entry = entry
        self._parts = parts            # [(host int32 [bucket, 1 + m], n_i, bucket)]
        self._n = n
        self._t0 = t0
        self._t_dispatch = t_dispatch
        self._done = done              # None on the CPU: already complete
        self._result: Optional[ClassifyResult] = None

    def result(self) -> ClassifyResult:
        if self._result is not None:
            return self._result
        if self._done is not None:
            self._done.synchronize()
        t2 = time.perf_counter()
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
        )
        return self._result


class ServingEngine:
    """Multi-model batched classification on one device.

    ``device``: where the register images live and the classify steps run;
    by default the current CUDA card, and with no card a ``RuntimeError``
    (pass ``device="cpu"`` to run the plain versions on the CPU).
    """

    def __init__(self, max_batch: int = 256, *, device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self._servables: Dict[str, _Entry] = {}

    # --- registry ---------------------------------------------------------

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
    ) -> ServableModel:
        """Freeze (if needed), attach the sparsity image
        (:func:`analyze_sparsity`), move to the engine's device once, and
        register a model under a dataset key.  ``path`` defaults to the
        config's ``eval_path``; ``booleanize_kw`` (``threshold``,
        ``block_size``, ``c``, ``levels``) sets the ingress knobs of both
        request routes.  ``version`` (or the servable's own stamp) gives
        epoch, step and digest; the id is the slot's next.  A
        ``ServableModel`` given here is copied, not moved: ``nn.Module.to``
        works in place, and the caller's image stays where it was."""
        if isinstance(model, ServableModel):
            servable = copy.deepcopy(model)
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
        prev = self._servables.get(name)
        stamp = ServableVersion(
            version=prev.version.version + 1 if prev is not None else 1,
            epoch=source.epoch if source else 0,
            step=source.step if source else 0,
            digest=source.digest if source and source.digest else servable_digest(servable),
        )
        servable = analyze_sparsity(servable).to(self.device)
        self._servables[name] = _Entry(
            servable=servable,
            booleanize_method=booleanize_method,
            booleanize_kw=booleanize_kw,
            path_name=path_name,
            ingress=ingress,
            stats=ServeStats(),
            version=stamp,
        )
        return servable

    def models(self) -> Tuple[str, ...]:
        return tuple(self._servables)

    def servable(self, name: str) -> ServableModel:
        return self._servables[name].servable

    def ingress_spec(self, name: str) -> IngressSpec:
        return self._servables[name].ingress

    def version(self, name: str) -> ServableVersion:
        """The stamp of the model served under ``name``."""
        return self._servables[name].version

    def stats(self, name: str) -> ServeStats:
        return self._servables[name].stats

    def resolved_path(self, name: str) -> str:
        """The path a dispatch of ``name`` really evaluates: the registered
        path, or its dense fallback when the servable carries no sparsity
        image."""
        entry = self._servables[name]
        return resolve_path(get_path(entry.path_name), entry.servable).name

    # --- serving ----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest power of two >= n, clamped to ``max_batch``."""
        if n < 1:
            raise ValueError("empty request")
        return min(1 << (n - 1).bit_length(), self.max_batch)

    def warmup(self, name: str, buckets=None) -> Tuple[int, ...]:
        """Run one zero batch per bucket (default: every power of two up to
        ``max_batch``), so the kernels are built and loaded and the
        allocators hold every bucket's buffers before the first request.
        Request statistics stay untouched.  Returns the buckets run."""
        entry = self._servables[name]
        if buckets is None:
            buckets = [1 << i for i in range(self.max_batch.bit_length())
                       if 1 << i < self.max_batch] + [self.max_batch]
        for b in buckets:
            if not 1 <= b <= self.max_batch:
                raise ValueError(f"warmup bucket {b} outside [1, max_batch={self.max_batch}]")
        done = tuple(dict.fromkeys(self.bucket_for(b) for b in buckets))
        for b in done:
            zeros = np.zeros((b,) + raw_trailing_shape(entry.ingress), np.uint8)
            self._submit_bucket(entry, zeros, record_hit=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return done

    @torch.inference_mode()
    def _submit_bucket(self, entry: _Entry, arr: np.ndarray, record_hit: bool = True,
                       form: str = "raw"):
        """Pad one <= max_batch slice to its bucket and run the classify
        step (raw pixels, or literals in the path's form) without waiting;
        returns ``(host_out, n, bucket)``, where ``host_out`` is int32
        ``[bucket, 1 + m]`` (predictions, class sums) that is complete once
        the device has caught up."""
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)          # packed words: same bits
        n = arr.shape[0]
        bucket = self.bucket_for(n)
        on_card = self.device.type == "cuda"
        host = torch.empty((bucket,) + arr.shape[1:], dtype=_torch_dtype(arr.dtype),
                           pin_memory=on_card)
        buf = host.numpy()
        buf[:n] = arr
        buf[n:] = 0
        x = host.to(self.device, non_blocking=True)
        path = get_path(entry.path_name)
        if form == "raw":
            v = run_path_raw(path, entry.servable, x, entry.ingress)
        else:
            v = run_path(path, entry.servable, x)
        out = torch.cat([cl.argmax_predict(v)[:, None], v], dim=1)
        if on_card:
            host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host_out.copy_(out, non_blocking=True)
        else:
            host_out = out
        if record_hit:
            hits = entry.stats.bucket_hits
            hits[bucket] = hits.get(bucket, 0) + 1
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
        Requests over ``max_batch`` go in ``max_batch`` slices."""
        if ingress not in ("device", "host"):
            raise ValueError(f"ingress must be 'device' or 'host', got {ingress!r}")
        entry = self._servables[name]
        t0 = time.perf_counter()
        if preprocessed or ingress == "host":
            arr = self.preprocess(name, images, preprocessed=preprocessed)
            form = "literals"
        else:
            arr = self.validate_raw(name, images)
            form = "raw"
        t1 = time.perf_counter()
        n = arr.shape[0]
        parts: List = [
            self._submit_bucket(entry, arr[i : i + self.max_batch], form=form)
            for i in range(0, n, self.max_batch)
        ]
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return InFlightClassify(entry, parts, n, t0, t1, done)

    def classify(self, name: str, images, *, preprocessed: bool = False,
                 ingress: str = "device") -> ClassifyResult:
        """Classify one request batch (``dispatch(...).result()``)."""
        return self.dispatch(name, images, preprocessed=preprocessed,
                             ingress=ingress).result()
