"""A closed loop of batch requests through ``ServingEngine.dispatch``.

Traffic parameters (``portbench/traffic/<name>.json``):

  * ``batch``: images in each request;
  * ``outstanding``: requests the one client keeps in flight; it waits
    for the oldest answer before it sends the next;
  * ``warm_calls``: requests sent before the window (judged too).

The pool is cut, in a seeded order, into ``pool // batch`` batches that
the client sends in turn, so every seed sends the same sizes.  The client
keeps the first answer to each batch and holds every later answer to it
(an answer that differs counts as wrong), so its memory stays flat.  A result
that comes back inside the window counts toward ``cls_per_s``; the
benchmark's clock around each ``dispatch()`` call is the engine's host
span.  With ``trace`` the client drains, then a further
``TRACE_SECONDS`` of the same loop run under the profiler, and drains
again, so the trace holds exactly the traced calls' device work.
"""

from __future__ import annotations

import collections
import gc
import sys
import time
import traceback

import numpy as np

from harness.cell import TRACE_SECONDS, Context, Outcome
from harness.trace import Tracer


def batches(rng: np.random.Generator, pool_n: int, batch: int) -> np.ndarray:
    """int64 ``[pool_n // batch, batch]`` pool indices, in a seeded order."""
    k = pool_n // batch
    if k < 1:
        raise ValueError(f"a pool of {pool_n} images holds no batch of {batch}")
    return rng.permutation(pool_n)[: k * batch].reshape(k, batch)


class _Loop:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.depth = int(ctx.traffic["outstanding"])
        self.idx = batches(ctx.rng, len(ctx.pool), int(ctx.traffic["batch"]))
        self.images = ctx.pool[self.idx]                # [k, batch, Y, X], built once
        self.k = 0
        self.first = {}          # batch -> (class sums, predictions) of its first answer
        self.times = collections.Counter()
        self.inconsistent = 0    # rows of later answers that differ from the first
        self.failed = 0

    def record(self, j: int, sums: np.ndarray, preds: np.ndarray) -> None:
        if j not in self.first:
            self.first[j] = (sums, preds)
        else:
            s0, p0 = self.first[j]
            if not (np.array_equal(sums, s0) and np.array_equal(preds, p0)):
                self.inconsistent += int(((sums != s0).any(axis=1) | (preds != p0)).sum())
                return
        self.times[j] += 1

    def fail(self) -> None:
        """Count a failed request; the first one's traceback goes to stderr."""
        if not self.failed:
            traceback.print_exc(file=sys.stderr)
        self.failed += 1

    def answers(self):
        return [(self.idx[j], s, p, self.times[j]) for j, (s, p) in self.first.items()]

    def drive(self, until: float, spans=None, on_answer=None, limit=None) -> int:
        """Send until ``until`` (perf_counter) or ``limit`` requests, keeping
        ``depth`` in flight, then drain; returns the requests sent."""
        eng, name = self.ctx.engine, self.ctx.name
        inflight = collections.deque()
        sent = 0
        while True:
            while (len(inflight) < self.depth and time.perf_counter() < until
                   and (limit is None or sent < limit)):
                j = self.k % len(self.idx)
                self.k += 1
                sent += 1
                t = time.perf_counter()
                try:
                    h = eng.dispatch(name, self.images[j])
                except Exception:
                    self.fail()
                    continue
                if spans is not None:
                    spans.append(time.perf_counter() - t)
                inflight.append((j, h))
            if not inflight:
                return sent
            j, h = inflight.popleft()
            try:
                r = h.result()
            except Exception:
                self.fail()
                continue
            t = time.perf_counter()
            self.record(j, r.class_sums, r.predictions)
            if on_answer is not None:
                on_answer(j, t)


def run(ctx: Context, seconds: float, trace: bool) -> Outcome:
    eng = ctx.engine
    lp = _Loop(ctx)
    eng.warmup(ctx.name, buckets=[eng.bucket_for(lp.idx.shape[1])], forms=("raw",))
    lp.drive(float("inf"), limit=int(ctx.traffic["warm_calls"]))
    if lp.failed:
        raise RuntimeError(f"warm-up: {lp.failed} requests failed")
    spans, in_window = [], []
    gc.collect()         # every run enters its window from the same collector state
    ctx.window_start = t0 = time.perf_counter()
    t_end = t0 + seconds

    def count(j, t):
        if t <= t_end:
            in_window.append(j)

    attempted = lp.drive(t_end, spans, count)
    failed = lp.failed
    trace_data, traced = None, None
    if trace:
        traced = []
        tracer = Tracer()
        tracer.start()
        lp.drive(time.perf_counter() + TRACE_SECONDS, on_answer=lambda j, t: traced.append(j))
        trace_data = tracer.stop()
        traced = [lp.idx[j] for j in traced]
    win_idx = lp.idx[np.asarray(in_window, np.int64)].reshape(-1)
    return Outcome(
        attempted=attempted, failed=failed, missing=0, answers=lp.answers(),
        inconsistent=lp.inconsistent, window_s=seconds,
        images_in_window=int(win_idx.size), window_pool_idx=win_idx,
        dispatch_s=np.asarray(spans), trace=trace_data, traced_calls=traced,
    )
