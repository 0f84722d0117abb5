"""engine.wait_ms_per_call: host time a traced engine call spends in the
program's ``engine.wait`` span, blocked on the card's completion event in
``InFlightClassify.result``: near 0 when the host sets the pace, the
card's lag behind the host when the card does.  Read under the profiler;
compare it across PRs, never with ``engine.host_ms_per_call``, which is
read in the untraced window on the benchmark's clock."""

from harness.spans import span_ms_per_call


def read(rec):
    return span_ms_per_call(rec, ("engine.wait",))
