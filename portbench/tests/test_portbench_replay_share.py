"""The reader of ``decode.replay_share``: 100 where the traced call's every
decode step opened one ``decode.replay`` span, 0 where none did (an eager
program, as on the CPU), nothing without a trace; and its reading in a
traced run of danube-decode on the CPU, where every step runs eagerly."""

import time

import pytest
import torch

from harness.cell import ROOT, Record, reader, run_cell
from harness.trace import TraceData

READ = reader(ROOT, "decode.replay_share")


def _rec(host, steps=4, trace=True):
    tr = (TraceData(start_us=0.0, end_us=1e4, device=[("nvjet_tst", 10.0, 20.0)], host=host)
          if trace else None)
    return Record(attempted=1, failed=0, missing=0, answers=[], window_s=1.0, trace=tr,
                  facts={"traced_steps": steps})


def test_one_replay_a_step_reads_100_none_reads_0_and_no_trace_nothing():
    replays = [("decode.replay", 100.0 + 1000 * i, 150.0 + 1000 * i) for i in range(4)]
    eager = [("aten::mm", 10.0, 20.0), ("cudaLaunchKernel", 30.0, 35.0)]
    assert READ(_rec(replays + eager)) == 100.0
    assert READ(_rec(replays[:1] + eager)) == 25.0
    assert READ(_rec(replays + [("decode.replay", 2e4, 2e4 + 50)])) == 100.0   # after the window
    got = READ(_rec(eager))
    assert got == 0.0 and isinstance(got, float)
    assert READ(_rec(replays, trace=False)) is None
    assert READ(_rec(replays, steps=None)) is None


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_danube_decode_on_the_cpu_reads_0(_threads):
    from repro_torch.configs import get_config, reduced_config

    rc = reduced_config(get_config("h2o-danube-1.8b"))
    keys = ("n_layers", "d_model", "n_heads", "head_dim", "d_ff", "vocab_size", "sliding_window")
    overrides = {"cfg": dict({k: getattr(rc, k) for k in keys}, n_kv_heads=2),
                 "traffic": {"batch": 4, "prompt": 8, "gen": 8, "max_seq": 16, "warm_prompt": 4,
                             "warm_gen": 4, "trace_prompt": 2, "trace_gen": 2}}
    out = run_cell("danube-decode", 2**33 + 9, 0.2, True, proc_start=time.perf_counter(),
                   device="cpu", overrides=overrides, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["metrics"]["decode.replay_share"] == {"value": 0.0, "unit": "%"}
