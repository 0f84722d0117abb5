"""Latency-aware microbatch scheduler for the async serving service
(a copy of ``repro/serve/scheduler.py``, which imports no JAX; the port
keeps its own because the reference's package does).

The chip reaches 60.3k classifications/s *and* 25.4 us single-image
latency because its DMA/frame pipeline keeps the datapath occupied
without ever parking a frame: a lone image is classified immediately,
while back-to-back frames ride the double-buffered image registers.  The
software analogue is a microbatcher with one knob, ``max_delay_us``:

  * a request batch is dispatched **immediately** once the queued images
    for its model fill the coalescing window (``max_coalesce``, normally
    the engine's ``max_batch`` bucket), so bursts ride full pow2
    buckets;
  * otherwise it is dispatched when the *oldest* queued request has
    waited ``max_delay_us`` — the bound on latency added by coalescing,
    which is what keeps batch-1 traffic on a 25.4 us-scale SLO while
    still giving concurrent submitters a chance to share a bucket.

This module is a pure synchronous state machine: per-model FIFO queues,
round-robin model selection, admission control against a ``high_water``
image depth.  All time is passed in explicitly (monotonic seconds), so
the policy is unit-testable with a fake clock; :mod:`repro_torch.serve.service`
drives it from an asyncio event loop and owns futures, threads and stats.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional

__all__ = ["PendingRequest", "QueueFull", "SchedulerConfig", "MicrobatchScheduler"]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Microbatching policy knobs.

    ``max_delay_us``: longest a queued request may wait for coalescing
    before its batch is dispatched anyway (0 = dispatch as soon as the
    worker looks at the queue — pure latency mode).
    ``high_water``: per-model admission limit in *images*; a submission
    that would push the queue past it is rejected (unless the queue is
    empty, so a single oversized request can always be served — the
    engine slices it internally).
    """

    max_delay_us: float = 200.0
    high_water: int = 4096

    def __post_init__(self):
        if self.max_delay_us < 0:
            raise ValueError("max_delay_us must be >= 0")
        if self.high_water < 1:
            raise ValueError("high_water must be >= 1")


class QueueFull(Exception):
    """Admission rejected: queued images would exceed the high-water mark."""

    def __init__(self, model: str, depth: int, high_water: int):
        super().__init__(
            f"queue for {model!r} holds {depth} images "
            f"(high_water={high_water})"
        )
        self.model = model
        self.depth = depth
        self.high_water = high_water


@dataclasses.dataclass
class PendingRequest:
    """One queued request: its image payload plus bookkeeping.

    ``literals`` holds either raw pixel batches (``preprocessed=False``,
    the default — the engine's device-resident ingress converts them
    in the raw classify step) or literals already in the model's
    eval-path input form (``preprocessed=True``); either way all
    requests of one form concatenate along the batch axis, so coalescing
    stays a plain ``np.concatenate``.  ``payload`` is opaque to the
    scheduler — the service stores the asyncio future that resolves the
    request there.

    ``version`` is the model's lifecycle version id at admission
    (0 = unversioned): :meth:`MicrobatchScheduler.pop_batch` never
    coalesces across a version boundary, so one microbatch is always
    attributable to a single model version even when a hot swap lands
    between two queued requests (ARCHITECTURE.md §Lifecycle).

    ``deadline_t`` is the request's absolute expiry (monotonic seconds,
    None = no deadline): a request still queued past it is shed by
    :meth:`MicrobatchScheduler.expire` *before* dispatch — the service
    reports it as ``ServiceExpired`` instead of computing a dead answer
    (ARCHITECTURE.md §Faults).
    """

    model: str
    literals: Any           # np.ndarray [n, ...] raw pixels or literals
    n: int                  # images in this request
    enqueue_t: float        # monotonic seconds at admission
    payload: Any = None
    preprocessed: bool = False
    version: int = 0        # model version id at admission (0 = unversioned)
    deadline_t: Optional[float] = None   # absolute expiry (None = none)

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t


class MicrobatchScheduler:
    """Per-model FIFO queues with round-robin, deadline-driven dispatch."""

    def __init__(self, config: Optional[SchedulerConfig] = None, *,
                 max_coalesce: int = 256):
        if max_coalesce < 1:
            raise ValueError("max_coalesce must be >= 1")
        self.config = config or SchedulerConfig()
        self.max_coalesce = max_coalesce
        self._queues: Dict[str, Deque[PendingRequest]] = {}
        self._depths: Dict[str, int] = {}
        # Round-robin cursor: models are served in registration order
        # starting after the last-served model, so a hot tenant cannot
        # starve the others.
        self._last_served: Optional[str] = None

    # --- admission --------------------------------------------------------

    def check_admission(self, model: str, n: int) -> None:
        """Raise :class:`QueueFull` if ``n`` more images would exceed the
        high-water mark.  Exposed separately so callers can shed load
        *before* paying the host-side ingress for a doomed request."""
        depth = self._depths.get(model, 0)
        if depth > 0 and depth + n > self.config.high_water:
            raise QueueFull(model, depth, self.config.high_water)

    def submit(self, req: PendingRequest) -> None:
        """Enqueue or raise :class:`QueueFull` (admission control)."""
        self.check_admission(req.model, req.n)
        self._queues.setdefault(req.model, collections.deque()).append(req)
        self._depths[req.model] = self._depths.get(req.model, 0) + req.n

    def depth(self, model: str) -> int:
        """Queued images for one model."""
        return self._depths.get(model, 0)

    def total_depth(self) -> int:
        """Queued images across all models."""
        return sum(self._depths.values())

    def models_with_work(self) -> List[str]:
        return [m for m, q in self._queues.items() if q]

    # --- dispatch policy --------------------------------------------------

    def _deadline(self, model: str) -> float:
        """When the oldest queued request's coalescing window expires."""
        return self._queues[model][0].enqueue_t + self.config.max_delay_us * 1e-6

    def _ready(self, model: str, now: float) -> bool:
        return (
            self._depths[model] >= self.max_coalesce
            or now >= self._deadline(model)
        )

    def _rotation(self) -> List[str]:
        """Models with work, round-robin order after the last served.

        Rotates over the stable (insertion-ordered) model list *before*
        filtering for work, so the cursor survives the last-served
        model's queue going empty.
        """
        names = list(self._queues)
        if self._last_served in names:
            i = names.index(self._last_served) + 1
            names = names[i:] + names[:i]
        return [m for m in names if self._queues[m]]

    def next_ready(self, now: float, *, force: bool = False) -> Optional[str]:
        """The model whose batch should be dispatched now, if any.

        ``force`` ignores deadlines (drain mode: flush everything).
        """
        for m in self._rotation():
            if force or self._ready(m, now):
                return m
        return None

    def earliest_deadline(self) -> Optional[float]:
        """When the next batch becomes dispatchable by deadline alone
        (None when no work is queued)."""
        work = self.models_with_work()
        if not work:
            return None
        return min(self._deadline(m) for m in work)

    def earliest_expiry(self) -> Optional[float]:
        """The soonest queued-request deadline (None when no queued
        request carries one) — the service folds this into its wait so a
        request expires on time, not at the next coalescing wakeup."""
        ts = [
            r.deadline_t
            for q in self._queues.values()
            for r in q
            if r.deadline_t is not None
        ]
        return min(ts) if ts else None

    def pop_batch(self, model: str) -> List[PendingRequest]:
        """Dequeue whole requests for one microbatch, FIFO order.

        Takes requests until adding the next would exceed
        ``max_coalesce`` images; always takes at least one (an oversized
        single request passes through — the engine serves it in
        ``max_batch`` slices).  Stops at a version boundary: requests
        admitted under different model versions never share a microbatch
        (the leftover tail is dispatched on the next rotation, so a swap
        costs at most one extra microbatch, never a dropped request).
        Advances the round-robin cursor.
        """
        q = self._queues[model]
        if not q:
            raise ValueError(f"no pending requests for {model!r}")
        batch = [q.popleft()]
        n = batch[0].n
        while (
            q
            and n + q[0].n <= self.max_coalesce
            and q[0].version == batch[0].version
        ):
            r = q.popleft()
            batch.append(r)
            n += r.n
        self._depths[model] -= n
        self._last_served = model
        return batch

    def expire(self, now: float) -> List[PendingRequest]:
        """Remove and return every queued request whose deadline passed.

        Queue order and depth accounting stay consistent for the
        survivors; the caller (the service) owns failing the shed
        requests' futures with ``ServiceExpired``.  Requests without a
        deadline never expire.
        """
        shed: List[PendingRequest] = []
        for m, q in self._queues.items():
            if not any(r.expired(now) for r in q):
                continue
            keep = collections.deque()
            for r in q:
                if r.expired(now):
                    shed.append(r)
                else:
                    keep.append(r)
            self._queues[m] = keep
            self._depths[m] -= sum(r.n for r in shed if r.model == m)
        return shed

    def drain_all(self) -> List[PendingRequest]:
        """Remove and return every queued request (hard stop)."""
        out: List[PendingRequest] = []
        for m, q in self._queues.items():
            out.extend(q)
            q.clear()
            self._depths[m] = 0
        return out
