"""Fault tolerance: straggler detection, restart protocol, elastic rescale.

A copy of ``repro/distributed/fault_tolerance.py`` with the same
semantics (this package imports nothing of the reference).

Everything here is deterministic control logic (unit-tested); the
side-effectful pieces (checkpoint I/O, mesh rebuild) are injected, so the
same policy runs in the CPU tests and on a real cluster agent.

At 1000+ nodes the relevant failure modes are (a) hard node loss — the
run must restart from the last committed checkpoint, possibly on fewer
chips (elastic), (b) stragglers — one slow host stalls every collective,
so per-step deadlines demand intervention long before a hard failure, and
(c) checkpoint corruption — only COMMITTED checkpoints are ever restored
and the newest K are retained (see checkpoint/).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

__all__ = ["StragglerPolicy", "HeartbeatMonitor", "run_with_restarts", "RestartStats"]


@dataclasses.dataclass
class StragglerPolicy:
    """Per-step deadline policy: a step slower than ``factor`` x the rolling
    median is a straggler event; ``tolerance`` consecutive events trigger
    intervention ('reshard' = drop slow hosts and rebuild the mesh).

    Returning 'reshard' **resets the policy**: strikes go back to zero and
    the duration history is cleared, because the intervention changes the
    mesh — the policy re-warms on post-reshard step times instead of
    escalating every subsequent step forever and comparing the new mesh
    against a median polluted by pre-reshard (straggler-inflated)
    durations."""

    factor: float = 3.0
    window: int = 32
    tolerance: int = 3
    _durations: List[float] = dataclasses.field(default_factory=list)
    _strikes: int = 0

    def observe(self, step_seconds: float) -> str:
        """Record one step duration; returns 'ok' | 'straggler' | 'reshard'."""
        hist = self._durations[-self.window:]
        self._durations.append(step_seconds)
        if len(hist) < max(4, self.window // 4):
            return "ok"
        med = sorted(hist)[len(hist) // 2]
        if step_seconds > self.factor * med:
            self._strikes += 1
            if self._strikes >= self.tolerance:
                self._strikes = 0
                self._durations.clear()
                return "reshard"
            return "straggler"
        self._strikes = 0
        return "ok"

    @property
    def median(self) -> Optional[float]:
        if not self._durations:
            return None
        h = sorted(self._durations[-self.window:])
        return h[len(h) // 2]


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-host heartbeats; hosts silent longer than ``timeout``
    are declared dead (feeds the elastic-restart decision).

    Call :meth:`expect` with the job's host roster at startup: a host
    that NEVER beats is otherwise invisible to ``dead_hosts`` (only
    hosts that beat at least once used to be tracked, so a node that
    died during bring-up was reported healthy forever)."""

    timeout: float = 60.0
    _last: Dict[str, float] = dataclasses.field(default_factory=dict)

    def expect(self, hosts, now: Optional[float] = None):
        """Register the roster: each host's silence clock starts NOW
        (unless it already beat).  Silent-from-birth hosts then age into
        ``dead_hosts`` after ``timeout`` like any other."""
        now = time.monotonic() if now is None else now
        for h in hosts:
            self._last.setdefault(h, now)

    def beat(self, host: str, now: Optional[float] = None):
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t > self.timeout)

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_hosts(now)


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0                 # total over the job (never reset)
    completed_steps: int = 0
    resumed_from: List[int] = dataclasses.field(default_factory=list)


def run_with_restarts(
    step_fn: Callable[[int], None],
    *,
    start_step: int,
    total_steps: int,
    save_fn: Callable[[int], None],
    restore_fn: Callable[[], int],
    checkpoint_every: int,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[Exception], None]] = None,
) -> RestartStats:
    """Checkpoint/restart driver.

    Runs ``step_fn(step)`` for steps [start_step, total_steps); on any
    exception restores via ``restore_fn() -> step`` (which may rebuild the
    mesh with a different chip count — elastic) and resumes.  This is the
    loop structure the launcher uses; tests inject failing step_fns.

    ``max_restarts`` bounds *consecutive* failures without checkpointed
    progress, not failures over the job's lifetime: each successful
    ``save_fn`` after newly completed steps resets the budget, so a
    long-lived run survives unrelated transient failures weeks apart while
    a crash loop (no progress between failures) still gives up after
    ``max_restarts``.  ``stats.restarts`` stays the lifetime total.
    """
    stats = RestartStats()
    step = start_step
    restarts = 0          # consecutive failures since checkpointed progress
    while step < total_steps:
        try:
            step_fn(step)
            stats.completed_steps += 1
            step += 1
            if step % checkpoint_every == 0 or step == total_steps:
                # save_fn only runs right after a successful step, so a
                # completed save IS checkpointed progress: the
                # transient-failure budget renews.
                save_fn(step)
                restarts = 0
        except Exception as e:  # noqa: BLE001 — any failure triggers restart
            # Recovery itself can fail (restore_fn hitting a corrupt or
            # unreachable checkpoint, on_restart's mesh teardown raising).
            # Each recovery failure consumes restart budget like the step
            # failure that triggered it — the loop keeps retrying recovery
            # until it succeeds or the budget runs out, instead of letting
            # a restore-time exception escape with budget unconsumed (and
            # the job's supervisor none the wiser about the attempts).
            err: Optional[Exception] = e
            while err is not None:
                restarts += 1
                stats.restarts += 1
                if restarts > max_restarts:
                    raise err
                try:
                    if on_restart is not None:
                        on_restart(err)
                    step = restore_fn()
                    stats.resumed_from.append(step)
                    err = None
                except Exception as e2:  # noqa: BLE001 — recovery failed too
                    err = e2
    return stats
