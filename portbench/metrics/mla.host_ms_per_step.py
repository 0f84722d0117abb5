"""mla.host_ms_per_step: host time a traced decode step spends in the
program's ``mla.attend`` spans (latent attention on the latent cache:
projections, rotation, cache write, absorbed scores and values), summed
over the layers, read under the profiler.  Compare it across PRs; never
with ``decode.ms_per_step``, which is read untraced."""

from harness.step_spans import span_ms_per_step


def read(rec):
    return span_ms_per_step(rec, ("mla.attend",))
