"""Open-loop Poisson arrivals of single requests through ``ServingService``.

Traffic parameters (``portbench/traffic/<name>.json``):

  * ``rate_per_s``: mean arrival rate, fixed in the mix;
  * ``images_per_request``: images in each request;
  * ``warm_requests``: requests sent at the same rate before the window,
    so the service's threads, the engine's buckets and the pinned host
    buffers are warm (their answers are judged too).

The service runs with its default ``ServiceConfig`` (raw pixels, ingress
on the device).  A window of ``seconds`` holds ``round(rate * seconds)``
requests at Poisson-like arrivals: one fixed set of exponential gaps,
scaled to span the window exactly, in an order drawn from the seed, so
every seed sends the same count and the same gaps over the same time.
Each request is timed from when it was due (not from when the service
admitted it) to when its future resolved on the event loop; a refused,
failed or unanswered request counts at ``FAIL_MS``.  Images answered
inside the window count toward ``cls_per_s``: above the service's
capacity, the rate it completes.  After the window the
engine's warm-up is not repeated: with ``trace`` a further
``TRACE_SECONDS`` of the same arrivals run under the profiler.
"""

from __future__ import annotations

import asyncio
import gc
import sys
import time

import numpy as np

from harness.cell import FAIL_MS, TRACE_SECONDS, Context, Outcome
from harness.trace import Tracer

#: Longest wait for the window's answers after it closes.
DRAIN_S = 60.0


def schedule(rng: np.random.Generator, rate: float, seconds: float, pool_n: int):
    """(due times in s from the window's start, pool indices): ``round(rate
    * seconds)`` arrivals whose gaps are the exponential distribution's
    quantiles at ``(i + 1/2) / n``, in an order drawn from ``rng`` and
    scaled to end at ``seconds``: every seed sends the same set of gaps
    (so the same bursts and lulls), in another order."""
    n = max(1, int(round(rate * seconds)))
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = np.cumsum(gaps) * (seconds / gaps.sum())
    return due, rng.integers(0, pool_n, n)


class _Batch:
    """The requests of one schedule: when each was due and sent, when it
    resolved, and its answer, in arrays filled by the futures' callbacks,
    so that the client holds no future or result once it has resolved (a
    client's objects would otherwise pile up in the service's process and
    lengthen its garbage collections)."""

    PENDING, OK, FAILED = 0, 1, 2

    def __init__(self, due: np.ndarray, idx: np.ndarray, per: int, m: int):
        n = len(due)
        self.due, self.idx, self.per = due, idx, per
        self.late = np.zeros(n)
        self.done_t = np.full(n, np.nan)
        self.status = np.zeros(n, np.int8)
        self.sums = np.zeros((n, per, m), np.int32)
        self.preds = np.zeros((n, per), np.int32)
        self.pending = 0
        self.settled = asyncio.Event()

    def resolve(self, i: int, t: float, fut) -> None:
        self.done_t[i] = t
        if fut.cancelled() or fut.exception() is not None:
            if not self.failed:
                why = "cancelled" if fut.cancelled() else repr(fut.exception())
                print(f"first failed request: {why}", file=sys.stderr)
            self.status[i] = self.FAILED
        else:
            r = fut.result()
            self.sums[i], self.preds[i] = r.class_sums, r.predictions
            self.status[i] = self.OK
        self.pending -= 1
        if self.pending == 0:
            self.settled.set()

    def answers(self):
        ok = self.status == self.OK
        rows = (self.idx[ok, None] + np.arange(self.per)).reshape(-1)
        m = self.sums.shape[-1]
        return [(rows, self.sums[ok].reshape(-1, m), self.preds[ok].reshape(-1), 1)]

    @property
    def failed(self) -> int:
        return int((self.status == self.FAILED).sum())

    @property
    def missing(self) -> int:
        return int((self.status == self.PENDING).sum())


async def _send(svc, name: str, pool: np.ndarray, b: _Batch, t0: float, on_first=None) -> None:
    """Submit request ``i`` at ``t0 + due[i]`` (loop clock), whatever the
    earlier ones are doing; a refused request is failed at once."""
    from repro_torch.serve.service import ServiceOverloaded

    loop = asyncio.get_running_loop()
    n, per = len(b.due), b.per
    i = 0
    while i < n:
        now = loop.time()
        while i < n and t0 + b.due[i] <= now:
            if i == 0 and on_first is not None:
                on_first()
            b.late[i] = now - (t0 + b.due[i])
            j = b.idx[i]
            try:
                f = svc.submit_nowait(name, pool[j : j + per])
            except ServiceOverloaded:
                b.status[i] = b.FAILED
                b.done_t[i] = now
                i += 1
                continue
            b.pending += 1
            f.add_done_callback(lambda fut, i=i: b.resolve(i, loop.time(), fut))
            i += 1
        if i < n:
            await asyncio.sleep(max(0.0, t0 + b.due[i] - loop.time()))


async def _settle(b: _Batch, timeout: float) -> None:
    """Wait up to ``timeout`` s for every sent request to resolve."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while b.pending:
        b.settled.clear()      # set whenever pending reached 0 while sending
        if b.pending == 0:
            return
        try:
            await asyncio.wait_for(b.settled.wait(), max(0.0, deadline - loop.time()))
        except asyncio.TimeoutError:
            return


async def _main(ctx: Context, seconds: float, trace: bool) -> Outcome:
    from repro_torch.serve.service import ServiceConfig, ServingService

    tr = ctx.traffic
    rate, per = float(tr["rate_per_s"]), int(tr["images_per_request"])
    pool_n, m = len(ctx.pool) - per + 1, ctx.cfg["n_classes"]
    ctx.engine.warmup(ctx.name, forms=("raw",))     # every power-of-two bucket
    loop = asyncio.get_running_loop()
    svc = ServingService(ctx.engine, ServiceConfig())
    await svc.start()
    try:
        n_warm = int(tr["warm_requests"])
        warm = _Batch(*schedule(ctx.rng, rate, n_warm / rate, pool_n), per, m)
        await _send(svc, ctx.name, ctx.pool, warm, loop.time())
        await _settle(warm, DRAIN_S)
        if warm.failed or warm.missing:
            raise RuntimeError(f"warm-up: {warm.failed} requests failed, "
                               f"{warm.missing} unanswered")

        win = _Batch(*schedule(ctx.rng, rate, seconds, pool_n), per, m)
        gc.collect()     # every run enters its window from the same collector state
        s0 = svc.stats(ctx.name)
        t0 = loop.time() + 0.001

        def first():
            ctx.window_start = time.perf_counter()

        await _send(svc, ctx.name, ctx.pool, win, t0, first)
        await _settle(win, t0 + seconds + DRAIN_S - loop.time())
        s1 = svc.stats(ctx.name)
        lat = (win.done_t - (t0 + win.due)) * 1e3
        lat = np.where(win.status == win.OK, lat, FAIL_MS)
        inside = (win.status == win.OK) & (win.done_t <= t0 + seconds)
        win_idx = (win.idx[inside, None] + np.arange(per)).reshape(-1)
        answers = warm.answers() + win.answers()
        missing = win.missing

        trace_data = None
        if trace:
            tail = _Batch(*schedule(ctx.rng, rate, TRACE_SECONDS, pool_n), per, m)
            tracer = Tracer()
            tracer.start()
            await _send(svc, ctx.name, ctx.pool, tail, loop.time() + 0.001)
            await _settle(tail, DRAIN_S)
            trace_data = tracer.stop()
            answers += tail.answers()
            missing += tail.missing
    finally:
        await svc.stop(drain=True)
    return Outcome(
        attempted=len(win.due), failed=win.failed, missing=missing, answers=answers,
        window_s=seconds, latencies_ms=lat, due_s=win.due, late_ms=win.late * 1e3,
        images_in_window=int(win_idx.size), window_pool_idx=win_idx,
        service_images=s1.images - s0.images, service_batches=s1.batches - s0.batches,
        trace=trace_data,
    )


def run(ctx: Context, seconds: float, trace: bool) -> Outcome:
    return asyncio.run(_main(ctx, seconds, trace))
