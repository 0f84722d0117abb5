"""engine.stage_ms_per_call: host time a traced engine call spends in the
program's ``engine.stage_in`` (pinned buffer, NumPy fill, H2D enqueue)
and ``engine.stage_out`` (pinned out-buffer, D2H enqueue, completion
event) spans, read under the profiler.  Compare it across PRs; never
with ``engine.host_ms_per_call``, which is read in the untraced window on
the benchmark's clock."""

from harness.spans import span_ms_per_call


def read(rec):
    return span_ms_per_call(rec, ("engine.stage_in", "engine.stage_out"))
