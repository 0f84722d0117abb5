"""Fault injection, degradation policy, and serving-health state (a copy
of ``repro/serve/faults.py``; ``chaos_soak`` drives this package's
``serve/loadgen.py``).

The ASIC's dependability story is trivial: a fixed-function datapath at
27.8 MHz has no failure modes short of power loss.  The software serving
spine (ServingService -> MicrobatchScheduler -> ServingEngine) has
plenty — a dead dispatch thread leaves ``submit()``
futures pending forever, a malformed payload in a coalesced microbatch
poisons its batchmates, a lost device kills every subsequent dispatch.
This module is the serving answer (ARCHITECTURE.md §Faults):

``FaultPlan``
    A deterministic injection plan threaded through the service and
    engine seams: worker crash at dispatch *k*, fixed slow-dispatch
    delays, poisoned payload marking, engine exceptions mid-microbatch,
    simulated device loss on the mesh's data axis.  Counter-based and
    thread-safe, so chaos tests replay exactly.

``DegradationPolicy``
    The circuit-breaker knobs: how many consecutive dispatch failures
    trip a fallback along the dense-fallback chain in ``serve/paths.py``
    (sparse -> dense twin, fused -> matmul, ... -> dense), and how many
    worker restarts (with bounded backoff) are attempted before the
    service drains instead of crash-looping.

``ServiceHealth``
    The observable state machine — ``healthy`` / ``degraded`` /
    ``draining`` — with the last-fault cause, the fallback path in use,
    and fault counters; exposed through ``ServiceStats`` snapshots.

Structured errors (``WorkerCrashed``, ``PoisonedPayload``,
``DeviceLost``, ``ServiceExpired``) are what request futures resolve
with when their request cannot be served: the request-lifetime guarantee
is that every admitted future resolves — with a result or one of these —
never hangs (``tests/test_torch_service.py`` holds the chaos soak).

``chaos_soak`` drives an adversarial open-loop load (via
``serve/loadgen.py``'s malformed/abandon knobs) against a service with
an injection plan and tallies how every future resolved.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Set, Tuple

__all__ = [
    "FaultError",
    "WorkerCrashed",
    "PoisonedPayload",
    "DeviceLost",
    "InjectedEngineError",
    "ServiceExpired",
    "FaultPlan",
    "DegradationPolicy",
    "ServiceHealth",
    "chaos_soak",
]


class FaultError(RuntimeError):
    """Structured serving fault: carries what broke (``kind``) and where
    (``model``, when known) so callers can triage without string
    parsing.  Every fault a request future resolves with derives from
    this (or is :class:`ServiceExpired`)."""

    kind = "fault"

    def __init__(self, message: str, *, model: Optional[str] = None):
        super().__init__(message)
        self.model = model


class WorkerCrashed(FaultError):
    """The dispatch worker died with this microbatch in flight.  The
    requests were never computed; the service restarts the worker with
    bounded backoff (``DegradationPolicy``) and keeps serving."""

    kind = "worker_crash"


class PoisonedPayload(FaultError):
    """A request payload marked poisoned (or failing only at dispatch)
    was isolated out of its microbatch; batchmates are unaffected."""

    kind = "poisoned_payload"


class DeviceLost(FaultError):
    """A mesh device (simulated) dropped out mid-dispatch; the service
    re-places servables on a shrunk mesh and retries."""

    kind = "device_loss"


class InjectedEngineError(FaultError):
    """A FaultPlan-injected engine failure mid-microbatch (stands in for
    a real runtime error at dispatch)."""

    kind = "engine_error"


class ServiceExpired(Exception):
    """The request's deadline passed before dispatch; it was shed from
    the queue without computing a dead answer."""

    def __init__(self, model: str, deadline_s: float, waited_s: float):
        super().__init__(
            f"request for {model!r} expired before dispatch "
            f"(deadline {deadline_s * 1e3:.1f} ms, waited "
            f"{waited_s * 1e3:.1f} ms)"
        )
        self.model = model
        self.deadline_s = deadline_s
        self.waited_s = waited_s


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection for the serving seams.

    Dispatch sequence numbers are 1-based and counted per seam:
    ``crash_at`` / ``device_loss_at`` / ``slow_dispatch_s`` fire on the
    *service* dispatch counter (one per microbatch dispatch attempt,
    quarantine retries excluded so a plan stays a script, not a
    feedback loop); ``engine_error_at`` fires on the *engine* dispatch
    counter (one per ``ServingEngine.dispatch`` call).  Payloads marked
    with :meth:`poison` fail at dispatch every time they are seen —
    poison is a property of the payload, which is exactly what lets the
    quarantine isolate it from its batchmates.

    All mutation is behind one lock: the seams run on the dispatch
    worker thread while tests poke the plan from the event loop.
    """

    crash_at: Tuple[int, ...] = ()          # service dispatches that crash the worker
    device_loss_at: Tuple[int, ...] = ()    # service dispatches that lose a device
    engine_error_at: Tuple[int, ...] = ()   # engine dispatches that raise
    slow_dispatch_s: float = 0.0            # added to every service dispatch

    def __post_init__(self):
        self._lock = threading.Lock()
        self._service_dispatches = 0
        self._engine_dispatches = 0
        self._poisoned: Set[int] = set()

    # --- seams ------------------------------------------------------------

    def on_service_dispatch(self, model: str) -> None:
        """Runs at the top of every service microbatch dispatch (on the
        dispatch worker thread).  May delay, crash the worker, or lose a
        device — in that order, so a plan can combine them."""
        with self._lock:
            self._service_dispatches += 1
            seq = self._service_dispatches
        if self.slow_dispatch_s > 0.0:
            time.sleep(self.slow_dispatch_s)
        if seq in self.crash_at:
            raise WorkerCrashed(
                f"injected worker crash at dispatch #{seq}", model=model
            )
        if seq in self.device_loss_at:
            raise DeviceLost(
                f"injected device loss at dispatch #{seq}", model=model
            )

    def on_engine_dispatch(self, model: str) -> None:
        """Runs inside ``ServingEngine.dispatch`` before any device work."""
        with self._lock:
            self._engine_dispatches += 1
            seq = self._engine_dispatches
        if seq in self.engine_error_at:
            raise InjectedEngineError(
                f"injected engine error at engine dispatch #{seq}", model=model
            )

    # --- poisoned payloads ------------------------------------------------

    def poison(self, payload) -> "FaultPlan":
        """Mark ``payload`` (an ndarray, by identity) as poisoned: any
        dispatch that includes it raises :class:`PoisonedPayload`.  The
        service keeps the submitted array object on the queued request,
        so identity survives admission."""
        with self._lock:
            self._poisoned.add(id(payload))
        return self

    def is_poisoned(self, payload) -> bool:
        with self._lock:
            return id(payload) in self._poisoned

    def check_payload(self, payload, model: str) -> None:
        if self.is_poisoned(payload):
            raise PoisonedPayload(
                "poisoned payload isolated at dispatch", model=model
            )

    # --- introspection ----------------------------------------------------

    @property
    def service_dispatches(self) -> int:
        with self._lock:
            return self._service_dispatches

    @property
    def engine_dispatches(self) -> int:
        with self._lock:
            return self._engine_dispatches


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Circuit-breaker and supervision knobs (ARCHITECTURE.md §Faults).

    ``failure_threshold``  — consecutive dispatch failures for one model
                             before its eval path falls back one step
                             along the dense-fallback chain.
    ``max_worker_restarts``— dispatch-worker restarts before the service
                             gives up and drains (fails queued requests)
                             instead of crash-looping.
    ``restart_backoff_s``  — first restart delay; doubles per restart up
                             to ``restart_backoff_max_s``.
    """

    failure_threshold: int = 3
    max_worker_restarts: int = 5
    restart_backoff_s: float = 0.05
    restart_backoff_max_s: float = 1.0

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.max_worker_restarts < 0:
            raise ValueError("max_worker_restarts must be >= 0")
        if self.restart_backoff_s < 0 or self.restart_backoff_max_s < 0:
            raise ValueError("backoff delays must be >= 0")

    def backoff_s(self, restart_n: int) -> float:
        """Delay before restart ``restart_n`` (1-based), doubling and
        capped."""
        return min(
            self.restart_backoff_s * (2 ** max(restart_n - 1, 0)),
            self.restart_backoff_max_s,
        )


@dataclasses.dataclass
class ServiceHealth:
    """Snapshot of the service's degradation state machine.

    ``state`` moves ``healthy`` -> ``degraded`` (a fallback path or a
    shrunk mesh is in use, or a worker was restarted) -> ``draining``
    (stop() was called, or the worker-restart budget ran out and the
    service is shedding its queue).  Degraded is sticky until the
    operator swaps/re-registers: the breaker never flaps back on its
    own.  Counters are service-wide; per-model expiry/quarantine counts
    live on ``ServiceStats``.
    """

    state: str = "healthy"
    last_fault: Optional[str] = None       # cause string of the latest fault
    fallback_path: Optional[str] = None    # engine path in use when degraded
    worker_restarts: int = 0
    dispatch_failures: int = 0
    quarantined: int = 0                   # requests isolated out of batches
    expired: int = 0                       # requests shed past deadline
    device_losses: int = 0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def note_fault(self, cause: Exception) -> None:
        self.last_fault = f"{type(cause).__name__}: {cause}"

    def degrade(self, cause: Exception) -> None:
        self.note_fault(cause)
        if self.state == "healthy":
            self.state = "degraded"


async def chaos_soak(
    service,
    name: str,
    requests,
    rate: float,
    *,
    seed: int = 0,
    deadline_s: Optional[float] = None,
    malformed_frac: float = 0.0,
    abandon_frac: float = 0.0,
    preprocessed: bool = False,
    gather_timeout_s: float = 30.0,
) -> Dict:
    """Drive an adversarial open-loop load and tally how it resolved.

    One driver for the chaos tests and ``bench_service.py``: Poisson
    arrivals (``serve/loadgen.py``) with a fraction of malformed
    payloads and client abandons, against a service that may carry a
    :class:`FaultPlan`.  Every admitted future is awaited with a
    timeout — a timeout means a future HUNG, which is the one outcome
    the robustness layer must never produce — and the tally of results
    vs structured errors is returned alongside the service's health
    snapshot.
    """
    import asyncio

    from repro_torch.serve.loadgen import poisson_open_loop

    report = await poisson_open_loop(
        service, name, requests, rate,
        seed=seed, preprocessed=preprocessed, deadline_s=deadline_s,
        malformed_frac=malformed_frac, abandon_frac=abandon_frac,
    )
    futures = [f for _, f in report.admitted] + [f for _, f in report.abandoned]
    tally = {
        "admitted": len(report.admitted),
        "abandoned": len(report.abandoned),
        "rejected": report.rejected,
        "malformed": report.malformed,
        "ok": 0,
        "expired": 0,
        "faulted": 0,
        "stopped": 0,
        "hung": 0,
    }
    outcomes = await asyncio.gather(
        *(asyncio.wait_for(asyncio.shield(f), gather_timeout_s) for f in futures),
        return_exceptions=True,
    )
    for out in outcomes:
        if isinstance(out, asyncio.TimeoutError):
            tally["hung"] += 1          # the forbidden outcome
        elif isinstance(out, ServiceExpired):
            tally["expired"] += 1
        elif isinstance(out, FaultError):
            tally["faulted"] += 1
        elif isinstance(out, Exception):
            tally["stopped"] += 1       # ServiceStopped / validation errors
        else:
            tally["ok"] += 1
    tally["health"] = service.health().as_dict()
    return tally
