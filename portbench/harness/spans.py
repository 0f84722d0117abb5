"""The program's own spans in a traced window (``repro_torch.spans``):
host ranges the port opens inside the engine, ingress and classify step,
read from the profiler's host events.  A program that opens none of them
(one built before they existed) gives no reading."""

from __future__ import annotations

from typing import Optional, Tuple


def span_ms_per_call(rec, names: Tuple[str, ...]) -> Optional[float]:
    """Host milliseconds a traced engine call spent inside the spans named
    ``names``, summed over those that start in the traced window; None
    when the window holds none of them."""
    tr = rec.trace
    if tr is None or not rec.traced_calls:
        return None
    spans = [e - s for n, s, e in tr.host if n in names and tr.start_us <= s <= tr.end_us]
    if not spans:
        return None
    return sum(spans) * 1e-3 / len(rec.traced_calls)
