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

Batch bucketing: requests are padded to the nearest power of two, clamped
to ``max_batch``; longer requests are served in ``max_batch`` slices.
Padding rows are zero images whose results are sliced off; no row can
affect another.  Buckets bound the set of shapes the kernels and the
caching allocator ever see, as they bound jit compiles in the reference.

Autotuning, meshes, fault injection and hot swap are not ported yet.
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
from repro_torch.serve.paths import get_path, resolve_path, run_path_raw
from repro_torch.serve.servable import ServableModel, analyze_sparsity, freeze

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
    path_name: str
    ingress: IngressSpec
    stats: ServeStats


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
    ) -> ServableModel:
        """Freeze (if needed), attach the sparsity image
        (:func:`analyze_sparsity`), move to the engine's device once, and
        register a model under a dataset key.  ``path`` defaults to the
        config's ``eval_path``.  A ``ServableModel`` given here is copied,
        not moved: ``nn.Module.to`` works in place, and the caller's image
        stays where it was."""
        if isinstance(model, ServableModel):
            servable = copy.deepcopy(model)
        else:
            if config is None:
                raise ValueError("config required when registering a CoTMModel")
            servable = freeze(model, config)
        path_name = path or servable.config.eval_path
        eval_path = get_path(path_name)
        ingress = eval_path.ingress_spec(servable.config.patch, method=booleanize_method)
        servable = analyze_sparsity(servable).to(self.device)
        self._servables[name] = _Entry(
            servable=servable,
            booleanize_method=booleanize_method,
            path_name=path_name,
            ingress=ingress,
            stats=ServeStats(),
        )
        return servable

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
    def _submit_bucket(self, entry: _Entry, arr: np.ndarray, record_hit: bool = True):
        """Pad one <= max_batch slice to its bucket and run the raw classify
        step without waiting; returns ``(host_out, n, bucket)``, where
        ``host_out`` is int32 ``[bucket, 1 + m]`` (predictions, class sums)
        that is complete once the device has caught up."""
        n = arr.shape[0]
        bucket = self.bucket_for(n)
        on_card = self.device.type == "cuda"
        host = torch.empty((bucket,) + arr.shape[1:], dtype=_torch_dtype(arr.dtype),
                           pin_memory=on_card)
        buf = host.numpy()
        buf[:n] = arr
        buf[n:] = 0
        x = host.to(self.device, non_blocking=True)
        v = run_path_raw(get_path(entry.path_name), entry.servable, x, entry.ingress)
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

    def dispatch(self, name: str, images) -> InFlightClassify:
        """Submit one raw request batch and return without waiting on the
        device; requests over ``max_batch`` go in ``max_batch`` slices."""
        entry = self._servables[name]
        t0 = time.perf_counter()
        arr = self.validate_raw(name, images)
        t1 = time.perf_counter()
        n = arr.shape[0]
        parts: List = [
            self._submit_bucket(entry, arr[i : i + self.max_batch])
            for i in range(0, n, self.max_batch)
        ]
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return InFlightClassify(entry, parts, n, t0, t1, done)

    def classify(self, name: str, images) -> ClassifyResult:
        """Classify one raw request batch (``dispatch(...).result()``)."""
        return self.dispatch(name, images).result()
