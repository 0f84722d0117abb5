"""moe.host_ms_per_step: host time a traced decode step spends in the
program's expert spans (``moe.route``: router, choice, sort and group
counts; ``moe.experts``: the gather, grouped products and combine;
``moe.shared``), summed over the MoE layers, read under the profiler.
Compare it across PRs; never with ``decode.ms_per_step``, which is read
untraced."""

from harness.step_spans import span_ms_per_step


def read(rec):
    return span_ms_per_step(rec, ("moe.route", "moe.experts", "moe.shared"))
