"""ingress.host_ms_per_call: host time a traced engine call spends in the
program's ``ingress.*`` spans (``ingress.booleanize``, ``ingress.pack``:
issuing the booleanize and the literal packing), read under the profiler.
Compare it across PRs; never with ``engine.host_ms_per_call``, which is
read in the untraced window on the benchmark's clock."""

from harness.spans import span_ms_per_call


def read(rec):
    return span_ms_per_call(rec, ("ingress.booleanize", "ingress.pack"))
