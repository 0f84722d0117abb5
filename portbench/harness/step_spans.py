"""The program's own spans in a traced LM call, per decode step: host
ranges the port opens inside its decode step (``repro_torch.spans``),
read from the profiler's host events.  A program that opens none of them
gives no reading."""

from __future__ import annotations

from typing import Optional, Tuple


def span_ms_per_step(rec, names: Tuple[str, ...]) -> Optional[float]:
    """Host milliseconds inside the spans named ``names`` that start in the
    traced window, over the traced call's decode steps; None when the
    window holds none of them."""
    tr, steps = rec.trace, rec.facts.get("traced_steps")
    if tr is None or not steps:
        return None
    spans = [e - s for n, s, e in tr.host if n in names and tr.start_us <= s <= tr.end_us]
    if not spans:
        return None
    return sum(spans) * 1e-3 / steps
