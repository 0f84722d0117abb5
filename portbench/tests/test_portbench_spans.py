"""The readers of the program's spans (``harness/spans.py`` and the
metrics ``ingress.host_ms_per_call``, ``engine.stage_ms_per_call``,
``engine.wait_ms_per_call``): milliseconds a traced call from a synthetic
trace, nothing from a trace without the program's spans, and a reading
of each in a traced run of the cell on the CPU."""

import time

import numpy as np
import pytest

from harness.cell import ROOT, Record, reader, run_cell
from harness.trace import TraceData

METRICS = ("ingress.host_ms_per_call", "engine.stage_ms_per_call", "engine.wait_ms_per_call")


def _rec(host, calls=2, start=0.0, end=10_000.0):
    tr = TraceData(start_us=start, end_us=end, device=[("fused_infer_kernel", 10.0, 20.0)],
                   host=host)
    return Record(attempted=calls, failed=0, missing=0, answers=[], window_s=1.0, trace=tr,
                  traced_calls=[np.arange(4)] * calls)


def test_span_readers_give_ms_per_call():
    host = [("portbench.traced_window", 0, 10_000),
            ("engine.dispatch", 100, 1_100), ("engine.stage_in", 110, 150),
            ("ingress.booleanize", 200, 700), ("aten::mul", 210, 220),
            ("ingress.pack", 700, 760), ("classify.clauses", 760, 900),
            ("engine.stage_out", 900, 930), ("engine.stage_out", 1_050, 1_060),
            ("engine.result", 1_200, 1_400), ("engine.wait", 1_210, 1_250),
            ("engine.dispatch", 2_000, 3_000), ("ingress.booleanize", 2_100, 2_500),
            ("ingress.pack", 2_500, 2_540), ("engine.stage_in", 2_010, 2_030),
            ("engine.stage_out", 2_900, 2_920), ("engine.wait", 3_100, 3_300),
            ("ingress.pack", 20_000, 20_500)]            # after the window: not counted
    rec = _rec(host)
    got = {m: reader(ROOT, m)(rec) for m in METRICS}
    assert got["ingress.host_ms_per_call"] == pytest.approx((500 + 60 + 400 + 40) / 2 / 1e3)
    assert got["engine.stage_ms_per_call"] == pytest.approx((40 + 30 + 10 + 20 + 20) / 2 / 1e3)
    assert got["engine.wait_ms_per_call"] == pytest.approx((40 + 200) / 2 / 1e3)


@pytest.mark.parametrize("metric", METRICS)
def test_span_readers_read_nothing_without_the_programs_spans(metric):
    read = reader(ROOT, metric)
    parent = [("portbench.traced_window", 0, 10_000), ("aten::mul", 10, 20),
              ("cudaLaunchKernel", 30, 35)]
    assert read(_rec(parent)) is None
    assert read(_rec([("engine.wait", 10, 20)], calls=0)) is None
    assert read(Record(attempted=1, failed=0, missing=0, answers=[], window_s=1.0)) is None


def test_traced_run_on_the_cpu_reads_the_span_metrics():
    out = run_cell("fmnist-bulk", 2**33 + 7, 0.3, True, proc_start=time.perf_counter(),
                   device="cpu", overrides={"cfg": {"pool_images": 32},
                                            "traffic": {"batch": 8, "warm_calls": 2}},
                   log=lambda s: None)
    assert out["correct"]
    for m in METRICS:
        assert out["metrics"][m]["value"] >= 0.0 and out["metrics"][m]["unit"] == "ms"
    assert out["metrics"]["ingress.host_ms_per_call"]["value"] > 0.0
