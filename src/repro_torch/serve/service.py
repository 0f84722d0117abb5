"""Async serving service: request queue + microbatcher over a ServingEngine
(counterpart of ``repro/serve/service.py``, over this package's engine).

:class:`~repro_torch.serve.engine.ServingEngine` is a synchronous library call;
this module is the *service* around it — the software counterpart of the
chip's full serving story (Sec. IV-C), where the 60.3k classifications/s
figure includes the DMA/frame system overhead, not just the datapath:

  * a bounded request queue with admission control: submissions that
    would push a model's queue past the high-water mark are rejected
    with :class:`ServiceOverloaded` carrying a ``retry_after_s`` hint
    (backpressure instead of unbounded latency collapse);
  * a latency-aware microbatcher (:mod:`repro_torch.serve.scheduler`) that
    coalesces concurrent requests into the engine's pow2 buckets under a
    ``max_delay_us`` deadline — lone requests stay on a 25.4 us-scale
    SLO budget, bursts ride full buckets;
  * multi-model tenancy with round-robin fairness across the registered
    servables;
  * graceful drain (``stop(drain=True)`` flushes every queued request
    before shutdown) and per-model :class:`ServiceStats` snapshots
    (queue depth, batch-occupancy histogram, p50/p99 latency, and the
    ingress vs device latency split; beside them queue wait, the
    dispatch and completion threads' time per microbatch, and the
    collector's runs and pauses, also as ``gc.gen<n>`` spans in a trace).

Raw-pixel fast path
-------------------
Requests are enqueued as **raw pixel batches** by default: admission
checks and a cheap shape validation are all the host-side work a request
pays, and the booleanize -> patches -> literals -> pack ingress runs
on the card in the engine's raw classify step (the ingress-pack kernel)
once per microbatch — amortized over every coalesced request instead of
paid per submission.  ``preprocessed=True`` literals and a
``host_ingress=True`` mode (the per-request host pipeline, kept as the
baseline)
remain available; mixed-form microbatches execute as one engine dispatch
per form.

Pipelined dispatch
------------------
The dispatch worker thread only *pads and submits* each microbatch
(``engine.dispatch`` — kernel launches and copies are asynchronous, and
the handle holds a CUDA event recorded after them) and hands the
in-flight handle to a completion thread that blocks on device results
and resolves the request futures.  Up to ``max_inflight`` microbatches
overlap this way — the asyncio analogue of the ASIC's double-buffered
image registers (frame k classifies while frame k+1 streams in), now
actually overlapping device compute with coalescing AND with the next
batch's dispatch.

Results are **bit-identical** to direct ``engine.classify`` calls no
matter how requests were coalesced: every form runs the engine's own
classify steps and the datapath has no cross-batch interaction (padding rows
cannot perturb real rows — see ``serve/engine.py``), so concatenating
requests and slicing the results back is exact.
``tests/test_torch_service.py`` holds this against the reference engine
under concurrent submitters, drain-under-load, and across
raw/preprocessed submission forms.

Request-lifetime guarantees (ARCHITECTURE.md §Faults)
-----------------------------------------------------
Every admitted future RESOLVES — with a result or a structured error,
never a hang — under any fault ``serve/faults.py`` can inject
(the chaos soak of ``tests/test_torch_service.py``).  The hardening
layers:

  * **deadlines**: ``submit(deadline_s=...)`` requests still queued past
    their deadline are shed *before* dispatch and fail with
    ``ServiceExpired`` (no compute spent on a dead answer);
  * **worker supervision**: a dead dispatch worker fails its in-flight
    microbatch with ``WorkerCrashed`` and is replaced under bounded
    exponential backoff (``DegradationPolicy``); past the restart budget
    the service drains instead of crash-looping;
  * **input quarantine**: when a coalesced microbatch fails at dispatch,
    its members are retried individually — a poisoned/malformed request
    fails alone, batchmates complete bit-identically;
  * **degraded modes**: a circuit breaker trips repeated per-model
    injected engine errors into ``engine.degrade_path`` (one step down
    the dense-fallback chain, still bit-identical to the plain versions;
    a real dispatch failure marks the service degraded and leaves the
    model on its path);
    a ``DeviceLost`` asks the engine to shrink its mesh
    (``engine.shrink_mesh``: half the data shards, every image re-placed;
    None, and nothing changed, on an unmeshed engine) and retries member
    by member.  ``ServiceHealth`` snapshots
    (healthy / degraded / draining, last fault, fallback path) ride on
    every :meth:`ServingService.stats` call.

Typical lifecycle::

    engine = ServingEngine(max_batch=256)
    engine.register("mnist", model, cfg, booleanize_method="threshold")
    service = ServingService(engine, ServiceConfig(max_delay_us=200.0))
    await service.start()
    result = await service.submit("mnist", images)     # or submit_nowait
    print(service.stats("mnist"))
    await service.stop(drain=True)
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import functools
import gc
import time
from concurrent.futures import BrokenExecutor, ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.serve.engine import InFlightClassify, ServingEngine
from repro_torch.serve.faults import (
    DegradationPolicy,
    DeviceLost,
    InjectedEngineError,
    PoisonedPayload,
    ServiceExpired,
    ServiceHealth,
    WorkerCrashed,
)
from repro_torch.serve.scheduler import (
    MicrobatchScheduler,
    PendingRequest,
    QueueFull,
    SchedulerConfig,
)
from repro_torch.spans import span

__all__ = [
    "ServiceConfig",
    "ServiceOverloaded",
    "ServiceResult",
    "ServiceStats",
    "ServiceStopped",
    "ServingService",
]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service knobs (the SLO surface).

    ``max_delay_us``  — microbatch coalescing deadline (see scheduler).
    ``high_water``    — per-model queued-image admission limit.
    ``max_coalesce``  — images per microbatch **per data shard**; scaled
                        by the engine's mesh data-axis size so a full
                        microbatch fills a full bucket on every device.
                        None = engine ``max_batch`` (already the global
                        largest bucket — used as-is).
    ``max_inflight``  — microbatches allowed between dispatch and device
                        completion (2 = double buffering).
    ``latency_window``— per-model ring buffer of request latencies the
                        p50/p99 snapshot is computed over.
    """

    max_delay_us: float = 200.0
    high_water: int = 4096
    max_coalesce: Optional[int] = None
    max_inflight: int = 2
    latency_window: int = 8192

    def __post_init__(self):
        # max_delay_us / high_water are re-validated by SchedulerConfig.
        if self.max_coalesce is not None and self.max_coalesce < 1:
            raise ValueError("max_coalesce must be >= 1 (or None)")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1")


class ServiceOverloaded(Exception):
    """Admission rejected; retry after ``retry_after_s`` (backpressure)."""

    def __init__(self, model: str, depth: int, retry_after_s: float):
        super().__init__(
            f"queue for {model!r} at high-water ({depth} images queued); "
            f"retry after {retry_after_s * 1e3:.1f} ms"
        )
        self.model = model
        self.depth = depth
        self.retry_after_s = retry_after_s


class ServiceStopped(RuntimeError):
    """The service is not accepting requests (not started, or stopping)."""


@dataclasses.dataclass
class ServiceResult:
    """One request's outcome, sliced back out of its microbatch.

    ``version`` is the monotonic id of the model version whose weights
    computed this result (captured atomically at engine dispatch, so a
    concurrent hot swap cannot mislabel it); ``batch_id`` identifies the
    microbatch it rode in — all members of one microbatch share a
    ``batch_id`` and, by the scheduler's version-boundary rule plus the
    dispatch-time swap guard, a single ``version``.
    """

    predictions: np.ndarray   # int32 [n]
    class_sums: np.ndarray    # int32 [n, m]
    latency_s: float          # enqueue -> result (queue wait + compute)
    bucket: int               # pow2 bucket the microbatch executed in
    batch_requests: int       # requests coalesced into that microbatch
    batch_images: int         # images in that microbatch
    version: int = 0          # model version id that computed it
    batch_id: int = 0         # service-wide microbatch sequence number
    queue_wait_s: float = 0.0  # enqueue -> popped into its microbatch


@dataclasses.dataclass
class ServiceStats:
    """Per-model service-level snapshot (engine stats stay separate)."""

    submitted: int = 0        # admission attempts (includes rejected)
    rejected: int = 0
    completed: int = 0        # requests resolved
    images: int = 0           # images classified through the service
    batches: int = 0          # microbatches executed
    expired: int = 0          # requests shed past their deadline
    quarantined: int = 0      # requests isolated out of failed microbatches
    queue_depth: int = 0      # images queued at snapshot time
    # bucket -> {"batches": ..., "images": ...}; occupancy of bucket b is
    # images / (batches * b).
    occupancy_hist: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict
    )
    mean_occupancy: float = 0.0
    p50_latency_us: float = 0.0
    p99_latency_us: float = 0.0
    # Where microbatch time goes, per image: host-side ingress/validation
    # vs device execution (the serving bottleneck, made visible).
    ingress_us_per_image: float = 0.0
    device_us_per_image: float = 0.0
    # Service-wide ServiceHealth snapshot (serve/faults.py): state,
    # last fault, fallback path, restart/fault counters.
    health: Dict = dataclasses.field(default_factory=dict)
    # Beside the reference's fields: queue wait (enqueue -> popped into a
    # microbatch, over the same ring as the latencies), the dispatch
    # thread's and the completion thread's host time per microbatch, and
    # the collector's runs and pauses (per generation 0, 1, 2) while the
    # service ran, process-wide.
    p50_queue_wait_us: float = 0.0
    p99_queue_wait_us: float = 0.0
    dispatch_us_per_batch: float = 0.0
    complete_us_per_batch: float = 0.0
    gc_collections: List[int] = dataclasses.field(default_factory=lambda: [0, 0, 0])
    gc_pause_us: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    gc_max_gen2_pause_us: float = 0.0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _ModelStats:
    """Mutable accumulator behind ServiceStats snapshots."""

    submitted: int = 0
    rejected: int = 0
    completed: int = 0
    images: int = 0
    batches: int = 0
    expired: int = 0
    quarantined: int = 0
    busy_s: float = 0.0
    ingress_s: float = 0.0
    device_s: float = 0.0
    dispatch_s: float = 0.0     # dispatch thread, summed over microbatches
    complete_s: float = 0.0     # completion thread, summed over microbatches
    occupancy_hist: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict
    )
    latencies: Optional[object] = None   # collections.deque, set on init
    queue_waits: Optional[object] = None  # collections.deque, set on init


class _CollectorWatch:
    """A ``gc.callbacks`` hook: counts the collector's runs and sums their
    pauses per generation, keeps the longest gen-2 pause, and opens a
    ``gc.gen<n>`` span over each pause so a stall shows in a trace."""

    def __init__(self):
        self.collections = [0, 0, 0]
        self.pause_s = [0.0, 0.0, 0.0]
        self.max_gen2_pause_s = 0.0
        self._open = None     # (generation, start, span) of the pause under way

    def __call__(self, phase: str, info: Dict) -> None:
        if phase == "start":
            gen = info["generation"]
            rng = span(f"gc.gen{gen}")
            rng.__enter__()
            self._open = (gen, time.perf_counter(), rng)
        elif self._open is not None:
            gen, t, rng = self._open
            self._open = None
            rng.__exit__(None, None, None)
            pause = time.perf_counter() - t
            self.collections[gen] += 1
            self.pause_s[gen] += pause
            if gen == 2:
                self.max_gen2_pause_s = max(self.max_gen2_pause_s, pause)

    def install(self) -> None:
        if self not in gc.callbacks:
            gc.callbacks.append(self)

    def remove(self) -> None:
        if self in gc.callbacks:
            gc.callbacks.remove(self)


def _timed(name: str, batch_id: int, fn):
    """``fn`` under the span ``name`` (carrying ``batch_id``), as a callable
    that returns ``(fn's result, host seconds it took)``."""

    def run():
        t = time.perf_counter()
        with span(name, batch_id=batch_id):
            out = fn()
        return out, time.perf_counter() - t

    return run


class ServingService:
    """Asyncio request queue + pipelined microbatcher around a ServingEngine.

    ``faults`` threads a :class:`~repro_torch.serve.faults.FaultPlan` through
    the dispatch seams (chaos tests only — None in production);
    ``policy`` sets the circuit-breaker / worker-supervision knobs
    (:class:`~repro_torch.serve.faults.DegradationPolicy`).
    """

    def __init__(
        self,
        engine: ServingEngine,
        config: Optional[ServiceConfig] = None,
        *,
        faults=None,
        policy: Optional[DegradationPolicy] = None,
    ):
        self.engine = engine
        self.config = config or ServiceConfig()
        self.policy = policy or DegradationPolicy()
        self._faults = faults
        self._health = ServiceHealth()
        # Circuit breaker: consecutive dispatch failures per model; reset
        # by any successful dispatch, tripped into engine.degrade_path at
        # policy.failure_threshold.
        self._consec_failures: Dict[str, int] = {}
        # Explicit max_coalesce is per data shard: on a meshed engine a
        # "full" microbatch must fill a full bucket on EVERY device, so
        # the window scales with the batch-shard count — but never past
        # the engine's largest bucket (one microbatch must stay one
        # dispatch, not a chain of max_batch slices).  An unmeshed
        # window explicitly set above max_batch is left alone (legacy
        # oversized-window behavior).  The None default (engine
        # ``max_batch``) is already the global largest bucket.
        if self.config.max_coalesce is None:
            max_coalesce = engine.max_batch
        else:
            max_coalesce = min(
                self.config.max_coalesce * engine.data_shards,
                max(engine.max_batch, self.config.max_coalesce),
            )
        self._sched = MicrobatchScheduler(
            SchedulerConfig(
                max_delay_us=self.config.max_delay_us,
                high_water=self.config.high_water,
            ),
            max_coalesce=max_coalesce,
        )
        self._mstats: Dict[str, _ModelStats] = {}
        self._task: Optional[asyncio.Task] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._completer: Optional[ThreadPoolExecutor] = None
        self._ingress: Optional[ThreadPoolExecutor] = None
        self._arrival: Optional[asyncio.Event] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._completions: Set[asyncio.Task] = set()
        self._accepting = False
        self._stopping = False
        self._draining = False
        self._batch_seq = 0          # microbatch sequence (ServiceResult.batch_id)
        self._gc = _CollectorWatch()

    # --- lifecycle --------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._task is not None

    async def start(self) -> None:
        """Start the dispatch loop; must run inside an event loop."""
        if self._task is not None:
            raise RuntimeError("service already started")
        self._accepting = True
        self._stopping = False
        self._draining = False
        self._arrival = asyncio.Event()
        self._inflight = asyncio.Semaphore(self.config.max_inflight)
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-dispatch"
        )
        self._completer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-complete"
        )
        self._ingress = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-ingress"
        )
        self._gc.install()
        self._task = asyncio.create_task(self._run(), name="serving-service")

    async def stop(self, *, drain: bool = True) -> None:
        """Shut down.  ``drain=True`` serves every queued request first
        (their futures resolve normally); ``drain=False`` fails queued
        requests with :class:`ServiceStopped` (already-dispatched
        microbatches still complete).  Idempotent."""
        task = self._task
        if task is None:
            return
        self._accepting = False
        self._stopping = True
        self._health.state = "draining"
        if drain:
            self._draining = True
        else:
            for r in self._sched.drain_all():
                if not r.payload.done():
                    r.payload.set_exception(
                        ServiceStopped("service stopped before dispatch")
                    )
        self._arrival.set()
        await task
        # In-flight microbatches resolve on the completion thread; wait
        # for all of them before tearing the executors down.
        while self._completions:
            await asyncio.gather(*tuple(self._completions))
        # Concurrent stop() calls all await the same task; only the first
        # to get here tears down.  The joins run off-loop: shutdown(wait=
        # True) blocks until each worker thread exits, and other tenants'
        # traffic (a second service on this loop, heartbeats) must keep
        # flowing while this one drains.
        if self._task is task:
            self._task = None
            self._gc.remove()
            for ex in (self._executor, self._completer, self._ingress):
                await asyncio.to_thread(ex.shutdown, True)
            self._executor = None
            self._completer = None
            self._ingress = None

    # --- lifecycle: hot swap (ARCHITECTURE.md §Lifecycle) -----------------

    async def swap(self, name: str, model, config=None, **kwargs):
        """Hot-swap ``name``'s weights under live load (awaitable).

        Runs ``engine.swap`` OFF the event loop (``asyncio.to_thread``):
        the swap acquires the engine lock, which the dispatch worker
        thread holds across each microbatch — blocking the loop on it
        would stall every tenant's coalescing (and, with the dispatch
        executor busy, deadlock the loop against its own worker; same
        off-loop rule as ``stop``'s executor joins).  Queued requests
        admitted before the swap complete on their admission version;
        the service keeps accepting throughout.  Returns the installed
        :class:`~repro_torch.serve.servable.ServableVersion`.
        """
        return await asyncio.to_thread(
            self.engine.swap, name, model, config, **kwargs
        )

    async def rollback(self, name: str):
        """Restore the previously served version (awaitable; off-loop
        for the same lock-discipline reasons as :meth:`swap`)."""
        return await asyncio.to_thread(self.engine.rollback, name)

    # --- submission -------------------------------------------------------

    def submit_nowait(
        self,
        name: str,
        images: np.ndarray,
        *,
        preprocessed: bool = False,
        deadline_s: Optional[float] = None,
    ) -> "asyncio.Future[ServiceResult]":
        """Admit a request and return the future of its result.

        Raw images (the default) are only shape-validated here — the
        booleanize/patch/pack ingress runs on the device in the
        microbatch's raw classify step.  ``preprocessed=True``
        validates already-converted literals; the legacy per-request
        host pipeline is :meth:`submit_host_nowait`.

        ``deadline_s`` bounds the request's lifetime: still queued that
        many seconds after admission, it is shed *before* dispatch and
        its future fails with :class:`~repro_torch.serve.faults.ServiceExpired`
        (no compute is spent on an answer nobody is waiting for).

        Raises :class:`ServiceStopped` when not accepting,
        :class:`ServiceOverloaded` past the high-water mark, and
        propagates the engine's validation errors (unknown model, empty
        request, wrong literal form or raw shape).  The returned future
        resolves with a :class:`ServiceResult` once the request's
        microbatch executes.
        """
        with span("service.admit"):
            if self._task is None or not self._accepting:
                raise ServiceStopped("service is not accepting requests")
            if deadline_s is not None and deadline_s <= 0:
                raise ValueError("deadline_s must be > 0 (or None)")
            # Admission first, on the image count alone: a rejected request
            # must not pay any per-image work (backpressure has to shed load,
            # not just refuse it after the expensive part).
            self._check_admission(name, len(images))
            if preprocessed:
                arr = self.engine.preprocess(name, images, preprocessed=True)
            else:
                arr = self.engine.validate_raw(name, images)
            ms = self._model_stats(name)
            ms.submitted += 1
            loop = asyncio.get_running_loop()
            now = loop.time()
            req = PendingRequest(
                model=name,
                literals=arr,
                n=int(arr.shape[0]),
                enqueue_t=now,
                payload=loop.create_future(),
                preprocessed=preprocessed,
                # Admission-time version id: pop_batch never coalesces across
                # a version boundary, so a swap landing mid-queue splits the
                # queue into per-version microbatches instead of mixing them.
                version=self.engine.version_id(name),
                deadline_t=None if deadline_s is None else now + deadline_s,
            )
            # No await between _check_admission above and this enqueue, so the
            # scheduler's own re-check cannot fail here.
            self._sched.submit(req)
            self._arrival.set()
            return req.payload

    def _check_admission(self, name: str, n: int) -> None:
        """Depth pre-check; converts QueueFull to ServiceOverloaded and
        counts the rejection.  Only a non-empty queue can reject, so the
        model is necessarily registered by then (stats exist)."""
        try:
            self._sched.check_admission(name, n)
        except QueueFull as e:
            ms = self._model_stats(name)
            ms.submitted += 1
            ms.rejected += 1
            raise ServiceOverloaded(
                name, e.depth, self._retry_after(name, e.depth)
            ) from e

    def submit_host_nowait(
        self, name: str, images: np.ndarray, *,
        deadline_s: Optional[float] = None,
    ) -> "asyncio.Future[ServiceResult]":
        """Admit a raw request through the legacy HOST ingress, without
        blocking the event loop: admission is checked synchronously here
        (so open-loop generators still see immediate rejections), then
        the per-request booleanize/patch/pack pipeline runs on the
        dedicated ingress thread and the literals enqueue when it
        finishes.  The pre-device-ingress baseline the raw path is
        compared against — serialized on one ingress thread, but never
        stalling the coalescer.
        """
        if self._task is None or not self._accepting:
            raise ServiceStopped("service is not accepting requests")
        self._check_admission(name, len(images))
        self.engine.validate_raw(name, images)
        loop = asyncio.get_running_loop()
        out: asyncio.Future = loop.create_future()

        async def _ingress_then_enqueue():
            try:
                lits = await loop.run_in_executor(
                    self._ingress,
                    functools.partial(self.engine.preprocess, name, images),
                )
                # The authoritative admission re-check inside
                # submit_nowait can still reject if the queue filled
                # during the ingress; that surfaces on the future.
                res = await self.submit_nowait(
                    name, lits, preprocessed=True, deadline_s=deadline_s
                )
                if not out.done():
                    out.set_result(res)
            except Exception as e:
                if not out.done():
                    out.set_exception(e)

        loop.create_task(_ingress_then_enqueue())
        return out

    async def submit(
        self,
        name: str,
        images: np.ndarray,
        *,
        preprocessed: bool = False,
        host_ingress: bool = False,
        deadline_s: Optional[float] = None,
    ) -> ServiceResult:
        """Admit a request and await its result.

        The default raw path enqueues pixels directly (cheap shape check
        only; the ingress runs on the device).  With
        ``host_ingress=True`` the legacy per-request host pipeline runs
        on a dedicated ingress thread first (:meth:`submit_host_nowait`),
        so it never blocks the event loop — kept for baseline
        comparisons.  ``deadline_s`` bounds the request's queue lifetime
        (see :meth:`submit_nowait`).
        """
        if host_ingress and not preprocessed:
            return await self.submit_host_nowait(
                name, images, deadline_s=deadline_s
            )
        return await self.submit_nowait(
            name, images, preprocessed=preprocessed, deadline_s=deadline_s
        )

    # --- stats ------------------------------------------------------------

    def stats(self, name: str) -> ServiceStats:
        """Snapshot one model's service-level stats.

        Raises KeyError for a model the engine doesn't know (same
        contract as ``engine.stats``); a registered model with no
        traffic yet snapshots as all zeros.
        """
        if name not in self._mstats:
            self.engine.servable(name)   # KeyError on unknown models
        ms = self._model_stats(name)
        lat = np.asarray(ms.latencies, np.float64) if ms.latencies else None
        wait = np.asarray(ms.queue_waits, np.float64) if ms.queue_waits else None
        occ_w = sum(
            h["batches"] * b for b, h in ms.occupancy_hist.items()
        )
        return ServiceStats(
            submitted=ms.submitted,
            rejected=ms.rejected,
            completed=ms.completed,
            images=ms.images,
            batches=ms.batches,
            expired=ms.expired,
            quarantined=ms.quarantined,
            queue_depth=self._sched.depth(name),
            occupancy_hist={
                b: dict(h) for b, h in sorted(ms.occupancy_hist.items())
            },
            mean_occupancy=ms.images / occ_w if occ_w else 0.0,
            p50_latency_us=(
                float(np.percentile(lat, 50) * 1e6) if lat is not None else 0.0
            ),
            p99_latency_us=(
                float(np.percentile(lat, 99) * 1e6) if lat is not None else 0.0
            ),
            ingress_us_per_image=(
                ms.ingress_s / ms.images * 1e6 if ms.images else 0.0
            ),
            device_us_per_image=(
                ms.device_s / ms.images * 1e6 if ms.images else 0.0
            ),
            health=self._health.as_dict(),
            p50_queue_wait_us=(
                float(np.percentile(wait, 50) * 1e6) if wait is not None else 0.0
            ),
            p99_queue_wait_us=(
                float(np.percentile(wait, 99) * 1e6) if wait is not None else 0.0
            ),
            dispatch_us_per_batch=(
                ms.dispatch_s / ms.batches * 1e6 if ms.batches else 0.0
            ),
            complete_us_per_batch=(
                ms.complete_s / ms.batches * 1e6 if ms.batches else 0.0
            ),
            gc_collections=list(self._gc.collections),
            gc_pause_us=[p * 1e6 for p in self._gc.pause_s],
            gc_max_gen2_pause_us=self._gc.max_gen2_pause_s * 1e6,
        )

    def health(self) -> ServiceHealth:
        """The service-wide degradation state machine (live object —
        snapshot with ``.as_dict()``)."""
        return self._health

    def _model_stats(self, name: str) -> _ModelStats:
        ms = self._mstats.get(name)
        if ms is None:
            ms = _ModelStats(
                latencies=collections.deque(maxlen=self.config.latency_window),
                queue_waits=collections.deque(maxlen=self.config.latency_window),
            )
            self._mstats[name] = ms
        return ms

    def _retry_after(self, name: str, depth: int) -> float:
        """Backpressure hint: time to work off the current queue at the
        observed service rate (coarse fallback before any batch ran)."""
        ms = self._model_stats(name)
        if ms.images and ms.busy_s:
            return depth * ms.busy_s / ms.images
        return max(self.config.max_delay_us * 1e-6, 1e-3)

    # --- dispatch loop ----------------------------------------------------

    async def _wait_arrival(self, timeout: Optional[float]) -> None:
        try:
            await asyncio.wait_for(self._arrival.wait(), timeout)
        except asyncio.TimeoutError:
            return
        self._arrival.clear()

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = loop.time()
            self._shed_expired(now)
            model = self._sched.next_ready(now, force=self._draining)
            if model is None:
                deadline = self._sched.earliest_deadline()
                # Wake for the sooner of "a batch becomes dispatchable"
                # and "a queued request expires", so ServiceExpired
                # resolves at the deadline, not at the next arrival.
                expiry = self._sched.earliest_expiry()
                if expiry is not None and (deadline is None or expiry < deadline):
                    deadline = expiry
                if deadline is None:
                    if self._stopping:
                        return
                    await self._wait_arrival(None)
                else:
                    await self._wait_arrival(max(deadline - now, 0.0))
                continue
            batch = self._sched.pop_batch(model)
            await self._execute(loop, model, batch)

    # --- request lifetime (ARCHITECTURE.md §Faults) -----------------------

    def _fail_expired(self, r: PendingRequest, now: float) -> None:
        ms = self._model_stats(r.model)
        ms.expired += 1
        self._health.expired += 1
        if not r.payload.done():
            deadline_s = (
                r.deadline_t - r.enqueue_t if r.deadline_t is not None else 0.0
            )
            r.payload.set_exception(
                ServiceExpired(r.model, deadline_s, now - r.enqueue_t)
            )

    def _shed_expired(self, now: float) -> None:
        """Fail every queued request whose deadline passed — before it
        costs a dispatch (the no-dead-answers rule)."""
        for r in self._sched.expire(now):
            self._fail_expired(r, now)

    @staticmethod
    def _form_groups(
        batch: List[PendingRequest],
    ) -> List[Tuple[bool, List[PendingRequest]]]:
        """Partition a microbatch by request form (raw vs preprocessed),
        preserving request order within each group — raw pixels and
        literals cannot share one concatenation."""
        groups: List[Tuple[bool, List[PendingRequest]]] = []
        for r in batch:
            if groups and groups[-1][0] == r.preprocessed:
                groups[-1][1].append(r)
            else:
                groups.append((r.preprocessed, [r]))
        # Merge non-adjacent same-form runs (order across groups does not
        # matter — each request is sliced back independently).
        merged: Dict[bool, List[PendingRequest]] = {}
        for flag, reqs in groups:
            merged.setdefault(flag, []).extend(reqs)
        return list(merged.items())

    async def _execute(
        self, loop, model: str, batch: List[PendingRequest]
    ) -> None:
        """Dispatch one coalesced microbatch (pad + submit, no device
        wait) on the dispatch thread, then hand completion to the
        completion thread so the loop keeps coalescing batch k+1 while
        batch k computes.

        Fault tiers (ARCHITECTURE.md §Faults): a dead worker fails the
        batch with ``WorkerCrashed`` and restarts the dispatch executor
        under backoff; a ``DeviceLost`` shrinks the mesh and retries the
        batch member-by-member; any other dispatch failure feeds the
        circuit breaker and quarantines — members retry individually so
        one poisoned request cannot take its batchmates down.
        """
        now = loop.time()
        live = [r for r in batch if not r.expired(now)]
        for r in batch:
            if r.expired(now):
                # Expired while pop_batch was deciding: still never
                # dispatched (the acceptance invariant).
                self._fail_expired(r, now)
        if not live:
            return
        batch = live
        await self._inflight.acquire()
        groups = self._form_groups(batch)
        self._batch_seq += 1
        batch_id = self._batch_seq

        def _dispatch() -> List[Tuple[List[PendingRequest], InFlightClassify]]:
            if self._faults is not None:
                # Chaos seams, on the worker thread: slow-dispatch delay,
                # injected crash / device loss, poisoned-payload check.
                self._faults.on_service_dispatch(model)
                for r in batch:
                    self._faults.check_payload(r.literals, model)
            out = []
            # One version across ALL form groups of this microbatch: the
            # guard (the engine lock) pins the entry so a concurrent swap
            # lands strictly before or strictly after the whole batch.
            with self.engine.swap_guard():
                for preprocessed, reqs in groups:
                    if len(reqs) == 1:
                        arr = reqs[0].literals
                    else:
                        arr = np.concatenate([r.literals for r in reqs], axis=0)
                    out.append(
                        (reqs, self.engine.dispatch(
                            model, arr, preprocessed=preprocessed
                        ))
                    )
            return out

        t0 = loop.time()
        try:
            inflights, dispatch_s = await loop.run_in_executor(
                self._executor, _timed("service.dispatch", batch_id, _dispatch)
            )
        except (WorkerCrashed, BrokenExecutor) as e:
            # The worker died with this batch in flight: the requests were
            # never computed — fail them with a structured error, then
            # replace the worker (bounded backoff) and keep serving.
            self._inflight.release()
            err = (
                e if isinstance(e, WorkerCrashed)
                else WorkerCrashed(f"dispatch worker died: {e}", model=model)
            )
            self._health.note_fault(err)
            for r in batch:
                if not r.payload.done():
                    r.payload.set_exception(err)
            await self._restart_worker(err)
            return
        except DeviceLost as e:
            # Simulated mesh-device loss: re-place every servable on a
            # shrunk mesh (off-loop — engine lock discipline, same as
            # swap) and retry the batch member-by-member on it.
            self._inflight.release()
            self._health.device_losses += 1
            self._health.degrade(e)
            await asyncio.to_thread(self.engine.shrink_mesh)
            await self._dispatch_isolated(loop, model, batch, now)
            return
        except Exception as e:
            self._inflight.release()
            await self._record_dispatch_failure(model, e)
            if len(batch) == 1:
                r = batch[0]
                ms = self._model_stats(model)
                ms.quarantined += 1
                self._health.quarantined += 1
                if not r.payload.done():
                    r.payload.set_exception(e)
                return
            # Quarantine: the failure could belong to ONE member of the
            # coalesced batch (poisoned/malformed input) — retry each
            # request alone so only the culprit fails.
            await self._dispatch_isolated(loop, model, batch, now)
            return
        self._consec_failures.pop(model, None)
        task = loop.create_task(
            self._complete(loop, model, batch, inflights, t0, batch_id,
                           popped_t=now, dispatch_s=dispatch_s),
            name=f"serve-complete-{model}",
        )
        self._completions.add(task)
        task.add_done_callback(self._completions.discard)

    async def _dispatch_isolated(
        self, loop, model: str, batch: List[PendingRequest], popped_t: float
    ) -> None:
        """Dispatch each member of a failed microbatch alone.

        The per-request failure domain: a member that fails again
        (poisoned payload, persistent engine error) fails ALONE with its
        structured error; every other member completes bit-identically
        to an uncoalesced submit.  Retries skip the FaultPlan's
        ``on_service_dispatch`` counter — an injection plan is a script
        over the primary dispatch sequence, not a feedback loop over its
        own retries — but still honor payload poison (a property of the
        request, not of the schedule).  ``popped_t`` is when the failed
        microbatch left the queue, which ends its members' queue wait.
        """
        for r in batch:
            if r.payload.done():
                continue
            now = loop.time()
            if r.expired(now):
                self._fail_expired(r, now)
                continue
            await self._inflight.acquire()
            self._batch_seq += 1
            batch_id = self._batch_seq

            def _one(req=r):
                if self._faults is not None:
                    self._faults.check_payload(req.literals, model)
                with self.engine.swap_guard():
                    return [(
                        [req],
                        self.engine.dispatch(
                            model, req.literals, preprocessed=req.preprocessed
                        ),
                    )]

            t0 = loop.time()
            try:
                inflights, dispatch_s = await loop.run_in_executor(
                    self._executor, _timed("service.dispatch", batch_id, _one)
                )
            except Exception as e:
                self._inflight.release()
                ms = self._model_stats(model)
                ms.quarantined += 1
                self._health.quarantined += 1
                self._health.note_fault(e)
                if not r.payload.done():
                    r.payload.set_exception(e)
                continue
            task = loop.create_task(
                self._complete(loop, model, [r], inflights, t0, batch_id,
                               popped_t=popped_t, dispatch_s=dispatch_s),
                name=f"serve-complete-{model}",
            )
            self._completions.add(task)
            task.add_done_callback(self._completions.discard)

    async def _record_dispatch_failure(self, model: str, e: Exception) -> None:
        """Feed the circuit breaker: at ``policy.failure_threshold``
        consecutive injected engine errors for one model, move its eval
        path one step down the degradation chain (bit-identical results,
        lower risk surface).

        Only the chaos seam's :class:`InjectedEngineError` counts.  Any
        other dispatch failure (a kernel's launch error or argument
        check, an out-of-memory on the card) fails its requests and marks
        the service degraded, but never moves the model off the kernels
        onto a plain path, where it would go on answering while its
        throughput and latency stopped being the kernels'.  The JAX
        reference's breaker steps down on any non-poison failure."""
        self._health.dispatch_failures += 1
        self._health.note_fault(e)
        if isinstance(e, PoisonedPayload):
            return   # a per-request fault says nothing about the path
        if not isinstance(e, InjectedEngineError):
            self._health.degrade(e)
            return
        k = self._consec_failures.get(model, 0) + 1
        self._consec_failures[model] = k
        if k < self.policy.failure_threshold:
            return
        self._consec_failures[model] = 0
        # Off-loop: degrade_path takes the engine lock (see swap()).
        nxt = await asyncio.to_thread(self.engine.degrade_path, model)
        if nxt is not None:
            self._health.degrade(e)
            self._health.fallback_path = nxt

    async def _restart_worker(self, cause: Exception) -> None:
        """Replace the dead dispatch executor under bounded backoff; past
        ``policy.max_worker_restarts`` the service drains (fails queued
        requests with ServiceStopped) instead of crash-looping."""
        self._health.worker_restarts += 1
        n = self._health.worker_restarts
        if n > self.policy.max_worker_restarts:
            self._health.state = "draining"
            self._health.note_fault(cause)
            self._accepting = False
            self._stopping = True
            for r in self._sched.drain_all():
                if not r.payload.done():
                    r.payload.set_exception(
                        ServiceStopped(
                            "worker-restart budget exhausted; service "
                            "draining"
                        )
                    )
            return
        self._health.degrade(cause)
        await asyncio.sleep(self.policy.backoff_s(n))
        old = self._executor
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-dispatch"
        )
        if old is not None:
            # The dead worker's queue is abandoned, not joined — its
            # in-flight batch already failed above.
            old.shutdown(wait=False)

    async def _complete(
        self,
        loop,
        model: str,
        batch: List[PendingRequest],
        inflights: List[Tuple[List[PendingRequest], InFlightClassify]],
        t0: float,
        batch_id: int = 0,
        *,
        popped_t: float,
        dispatch_s: float,
    ) -> None:
        """Block on device results (completion thread) and slice them back
        to the member requests."""
        try:
            results, complete_s = await loop.run_in_executor(
                self._completer,
                _timed("service.complete", batch_id,
                       lambda: [(reqs, h.result()) for reqs, h in inflights]),
            )
        except Exception as e:
            self._health.note_fault(e)
            for r in batch:
                if not r.payload.done():
                    r.payload.set_exception(e)
            return
        finally:
            self._inflight.release()
        t1 = loop.time()

        n = sum(r.n for r in batch)
        ms = self._model_stats(model)
        ms.batches += 1
        ms.images += n
        ms.busy_s += t1 - t0
        ms.dispatch_s += dispatch_s
        ms.complete_s += complete_s
        for reqs, res in results:
            ms.ingress_s += res.ingress_s
            ms.device_s += res.device_s
            ng = sum(r.n for r in reqs)
            # Histogram by *engine slice*: a group larger than max_batch
            # (one oversized request) executes as several buckets, and
            # occupancy must stay a <= 1 fraction of each executed bucket.
            for off in range(0, ng, self.engine.max_batch):
                m = min(self.engine.max_batch, ng - off)
                hist = ms.occupancy_hist.setdefault(
                    self.engine.bucket_for(m), {"batches": 0, "images": 0}
                )
                hist["batches"] += 1
                hist["images"] += m
            off = 0
            for r in reqs:
                out = ServiceResult(
                    predictions=res.predictions[off : off + r.n],
                    class_sums=res.class_sums[off : off + r.n],
                    latency_s=t1 - r.enqueue_t,
                    bucket=res.bucket,
                    batch_requests=len(batch),
                    batch_images=n,
                    version=res.version,
                    batch_id=batch_id,
                    queue_wait_s=popped_t - r.enqueue_t,
                )
                off += r.n
                ms.completed += 1
                ms.latencies.append(out.latency_s)
                ms.queue_waits.append(out.queue_wait_s)
                if not r.payload.done():
                    r.payload.set_result(out)
