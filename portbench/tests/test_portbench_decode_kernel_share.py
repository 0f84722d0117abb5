"""The reader of ``attn.decode_kernel_share``: 100 where the traced call
ran one ``gqa_decode`` device row a layer and step, 0 where it ran none
(the attention in torch operations), nothing without a trace or the
call's shape or for a configuration of another system than
``lm_decode``; and its reading in a traced run of danube-decode on the
CPU, where the attention runs in torch operations."""

import time

import pytest
import torch

from harness.cell import ROOT, Record, reader, run_cell
from harness.trace import TraceData

READ = reader(ROOT, "attn.decode_kernel_share")
KERNEL_ROW = "void (anonymous namespace)::gqa_decode_kernel<__nv_bfloat16, 4>(...)"


def _rec(device, steps=4, trace=True, shape=(256, 2, 2), layers=24, system="lm_decode"):
    tr = TraceData(start_us=0.0, end_us=1e4, device=device, host=[]) if trace else None
    return Record(attempted=1, failed=0, missing=0, answers=[], window_s=1.0, trace=tr,
                  facts={"traced_steps": steps, "call_shape": shape},
                  cfg={"n_layers": layers, "system": system})


def test_one_kernel_row_a_layer_and_step_reads_100_none_reads_0_and_no_trace_nothing():
    others = [("nvjet_tst_128x64", 1.0, 2.0), ("elementwise_kernel direct_copy_", 3.0, 4.0)]
    rows = [(KERNEL_ROW, 10.0 + i, 10.5 + i) for i in range(4 * 24)]
    assert READ(_rec(others + rows)) == 100.0
    assert READ(_rec(others + rows[:48])) == 50.0
    got = READ(_rec(others))
    assert got == 0.0 and isinstance(got, float)
    assert READ(_rec(others + rows, trace=False)) is None
    assert READ(_rec(others + rows, shape=None)) is None
    assert READ(_rec(others + rows, steps=None)) is None


@pytest.mark.parametrize("system", ["kimi_linear_decode", "mla_moe_decode", None])
def test_a_configuration_of_another_system_reads_nothing(system):
    """Its layers are not all attention layers (KDA, latent attention), so
    the rows are not counted against its ``n_layers``."""
    rows = [(KERNEL_ROW, 10.0 + i, 10.5 + i) for i in range(4 * 24)]
    assert READ(_rec(rows, system=system)) is None


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
    out = run_cell("danube-decode", 2**33 + 11, 0.2, True, proc_start=time.perf_counter(),
                   device="cpu", overrides=overrides, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["metrics"]["attn.decode_kernel_share"] == {"value": 0.0, "unit": "%"}
