"""The traced window: ``torch.profiler`` over a stretch of the cell's
traffic, read into device busy time, device operations by name, and the
host activity in each gap where the device was idle.

Device rows are the profiler's events on the card (kernels, copies,
memsets).  Busy time is the union of their intervals inside the window
(overlaps merged), so ``busy_s <= window_s``.  The window is the span
``portbench.traced_window`` that :class:`Tracer` opens around the traced
traffic.  An idle gap is named by the innermost host event (operator,
CUDA runtime call, or a span of the benchmark's own) that covers its
midpoint on any thread, or ``python`` where none does.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceData", "Tracer", "merge_intervals"]

WINDOW_SPAN = "portbench.traced_window"


def merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def short_name(name: str) -> str:
    """A device or host operation's name without its argument list."""
    n = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    if "(" in n and not n.startswith(("Memcpy", "Memset")):
        n = n[: n.index("(")]
    return n[:96]


@dataclasses.dataclass
class TraceData:
    """What one traced window held.  Times in microseconds of the
    profiler's clock."""

    start_us: float
    end_us: float
    device: List[Tuple[str, float, float]]     # (name, start, end), clipped to the window
    host: List[Tuple[str, float, float]]       # (name, start, end)
    read_s: float = 0.0                        # host seconds spent reading the events

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merge_intervals([(s, e) for _, s, e in self.device])) * 1e-6

    def kernel(self, part: str) -> Tuple[int, float]:
        """(launches, seconds) of the device rows whose name holds ``part``."""
        rows = [(s, e) for n, s, e in self.device if part in n]
        return len(rows), sum(e - s for s, e in rows) * 1e-6

    def device_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations with the most time: [name, seconds]."""
        tot: Dict[str, float] = {}
        for name, s, e in self.device:
            k = short_name(name)
            tot[k] = tot.get(k, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time by what the host was doing: the ``n`` host activities
        that covered the most idle time, [name (gaps), seconds]."""
        busy = merge_intervals([(s, e) for _, s, e in self.device])
        gaps, t = [], self.start_us
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end_us > t:
            gaps.append((t, self.end_us))
        host = sorted(self.host, key=lambda h: h[1])
        heap: List[Tuple[float, float, str]] = []    # (duration, end, name)
        i = 0
        tot: Dict[str, List[float]] = {}
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + e) / 2
            while i < len(host) and host[i][1] <= mid:
                name, hs, he = host[i]
                heapq.heappush(heap, (he - hs, he, name))
                i += 1
            # Shortest first: an ended event on top ended before every later
            # midpoint too, so it goes; the first that has not covers mid.
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "python"
            slot = tot.setdefault(short_name(name), [0.0, 0])
            slot[0] += (e - s) * 1e-6
            slot[1] += 1
        top = sorted(tot.items(), key=lambda kv: -kv[1][0])[:n]
        return [[f"{k} ({int(c)} gaps)", v] for k, (v, c) in top]


class Tracer:
    """``torch.profiler`` (host and card) around the traced traffic, with
    the window span open from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self._span = None

    def start(self) -> None:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        import torch

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:    # operators on every thread: the service dispatches from its own
            cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        except (AttributeError, TypeError):
            cfg = None
        self._prof = profile(activities=acts, experimental_config=cfg)
        self._prof.start()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> TraceData:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        t = time.perf_counter()
        events = self._prof.events()
        window: Optional[Tuple[float, float]] = None
        device, host = [], []
        for ev in events:
            s, e = float(ev.time_range.start), float(ev.time_range.end)
            on_card = getattr(ev, "device_type", None) == DeviceType.CUDA
            if ev.name == WINDOW_SPAN:
                if not on_card:      # on the card the span shows again, as an annotation
                    window = (s, e)
            elif on_card:
                device.append((ev.name, s, e))
            else:
                host.append((ev.name, s, e))
        if window is None:
            raise RuntimeError(f"the profiler recorded no {WINDOW_SPAN} span")
        w0, w1 = window
        device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
        return TraceData(start_us=w0, end_us=w1, device=device, host=host,
                         read_s=time.perf_counter() - t)
