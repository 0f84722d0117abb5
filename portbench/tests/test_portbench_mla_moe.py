"""The latent-attention MoE decode cell on the CPU at a reduced size: the
configuration against the program's arch, the benchmark's reference
against the tier-1 tests' copy, the yardstick by hand, the system's facts
into its four metrics, the cell run through the harness, the float8
control, and the timed path broken underneath coming out not correct."""

import json
import math
import sys
import time

import numpy as np
import pytest
import torch

from harness import mla_moe_reference as ref_mod
from harness import mla_moe_yardstick as yard
from harness.cell import ROOT, Record, checks_pass, execute, reader, run_cell, system
from harness.trace import TraceData

CELL = "moonlight-decode"
#: Moonlight's block at the tier-1 tests' reduced size: 3 layers (1 dense +
#: 2 MoE), d 64, 4 heads, nope 16 / rope 8 / v 16, latent 32, 8 experts
#: top-3 of width 32, 2 shared, vocab 512; the recorder armed for the
#: warm-up's 4 + 4 decode steps and the window's first call's 8 + 16.
REDUCED = {"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
           "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
           "num_experts_per_tok": 3, "moe_intermediate_size": 32, "intermediate_size": 128,
           "vocab_size": 512, "route_steps": 32}
TRAFFIC = {"batch": 4, "prompt": 8, "gen": 16, "max_seq": 24, "warm_prompt": 4, "warm_gen": 4,
           "trace_prompt": 2, "trace_gen": 2}
OVERRIDES = {"cfg": REDUCED, "traffic": TRAFFIC}


def _cfg(**kw):
    cfg = json.loads((ROOT / "portbench/configs/moonlight-16b-a3b.json").read_text())
    cfg.update(REDUCED, **kw)
    return cfg


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(trace=False, seed=2**41 + 5):
    return run_cell(CELL, seed, 0.4, trace, proc_start=time.perf_counter(), device="cpu",
                    overrides=OVERRIDES, log=lambda s: None)


def test_the_configuration_configures_the_registered_arch_at_its_widths():
    from repro_torch.configs import get_config

    cfg = json.loads((ROOT / "portbench/configs/moonlight-16b-a3b.json").read_text())
    mod = system(ROOT, cfg)
    assert mod.model_config(cfg) == get_config(cfg["arch"])
    n = sum(math.prod(s) for name, s, _, kind in ref_mod.leaves(cfg) if kind != "norm"
            and not name.endswith("router_bias"))
    assert n == 15_959_982_080                   # 31.92 GB in bf16
    assert yard.active_matrix_params(cfg) == 2_579_103_744
    assert yard.attention_flops_per_position(cfg) == 10_240
    with pytest.raises(KeyError):                # a program without the arch fails at once
        mod.model_config(dict(cfg, arch="no-such-arch"))
    with pytest.raises(ValueError):
        mod.model_config(dict(cfg, q_lora_rank=1536))


def test_the_two_reference_copies_give_equal_logits():
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import _plain_mla_moe as plain
    finally:
        sys.path.remove(str(ROOT / "tests"))
    cfg = _cfg(torch_dtype="float32")
    cfg["assumed"] = dict(cfg["assumed"], router_std=0.3, bias_std=0.1)
    w = ref_mod.make_weights(cfg, 12, "cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (5, 11)))
    got = torch.cat([lg for _, lg in ref_mod.logits_blocks(w, cfg, ids, block=2, head_block=3)])
    torch.testing.assert_close(got, plain.logits(w, cfg, ids), rtol=1e-5, atol=1e-5)


def test_model_flops_of_a_call_by_hand():
    cfg = _cfg()
    d, h, r, nope, rope, v = 64, 4, 32, 16, 8, 16
    attn = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v) + h * v * d
    moe = d * 8 + 3 * 3 * d * 32 + 3 * d * 64
    active = 3 * attn + 3 * d * 128 + 2 * moe + d * 512
    assert yard.active_matrix_params(cfg) == active
    per_pos = 2 * h * (nope + rope) + 2 * h * v
    want = 2 * (2 * active * 20 + 3 * per_pos * sum(range(1, 21)))
    assert yard.call_flops(cfg, 2, 20) == want


def test_the_experts_bound_by_hand():
    cfg = json.loads((ROOT / "portbench/configs/moonlight-16b-a3b.json").read_text())
    card = {"sms": 132, "max_sm_clock_mhz": 1980.0}
    ends = np.array([0, 10, 10, 30] + [30] * 60, dtype=np.int32)   # 2 experts hit, 30 pairs
    nbytes = 2 * (2 * 3 * 2048 * 1408 + 3 * 30 * (2048 + 1408))
    flops = 2 * 3 * 2048 * 1408 * 30
    rate = 132 * 1980e6 * 4096
    assert yard.experts_bound_s(cfg, [ends, ends], card) == pytest.approx(
        2 * max(nbytes / 3.35e12, flops / rate))


def test_the_systems_facts_reach_its_four_metrics():
    cfg = json.loads((ROOT / "portbench/configs/moonlight-16b-a3b.json").read_text())
    card = {"sms": 132, "max_sm_clock_mhz": 1980.0, "hbm_bytes_per_s": 3.35e12}
    ends = np.arange(1, 65, dtype=np.int32) * 24                   # every expert, 24 pairs each
    tr = TraceData(start_us=0.0, end_us=1e5, device=[
        ("cutlass::device_kernel<...GroupProblemShape...>", 0, 3000),
        ("at::cuda::detail::prepare_grouped_gemm_data<...>", 3000, 3010),
        ("nvjet_tst_128x16", 3010, 4000)],
        host=[("moe.route", 10, 30), ("moe.experts", 30, 80), ("moe.shared", 80, 90),
              ("mla.attend", 100, 160), ("mla.attend", 200, 240), ("aten::mm", 0, 5)])
    rec = Record(attempted=1, failed=0, missing=0, answers=[], window_s=10.0, trace=tr,
                 cfg=cfg, card=card,
                 facts={"steps_in_window": 4 * 256, "call_shape": (256, 128, 128),
                        "traced_steps": 2, "expert_counts": [ends, ends]})
    rate = 132 * 1980e6 * 4096
    assert reader(ROOT, "mfu.decode_moe")(rec) == pytest.approx(
        100 * 4 * yard.call_flops(cfg, 256, 256) / (10.0 * rate))
    assert reader(ROOT, "moe.experts_roofline")(rec) == pytest.approx(
        100 * yard.experts_bound_s(cfg, [ends, ends], card) / 3010e-6)
    assert reader(ROOT, "moe.host_ms_per_step")(rec) == pytest.approx(80e-3 / 2)
    assert reader(ROOT, "mla.host_ms_per_step")(rec) == pytest.approx(100e-3 / 2)
    # A program without the spans, counts or grouped products: no reading.
    bare = Record(attempted=1, failed=0, missing=0, answers=[], window_s=10.0, cfg=cfg, card=card,
                  trace=TraceData(0.0, 1e5, device=[("nvjet", 0, 10)], host=[]),
                  facts={"traced_steps": 2})
    for name in ("moe.experts_roofline", "moe.host_ms_per_step", "mla.host_ms_per_step",
                 "mfu.decode_moe"):
        assert reader(ROOT, name)(bare) is None


def test_the_cell_is_correct_and_reads_its_metrics():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    c = out["checks"]
    assert c["steps_compared"]["value"] == 8 and c["tokens_off_margin"]["value"] == 0
    assert c["forced_tokens_compared"]["value"] == 4 * (4 + 16)      # warm-up and window call
    assert c["tokens_compared"]["value"] >= c["tokens_compared"]["min"]
    out = _run(trace=True)
    assert out["correct"]
    got = set(out["metrics"])
    assert {"decode.ms_per_step", "moe.host_ms_per_step", "mla.host_ms_per_step"} <= got
    assert not {"mfu.decode_moe", "moe.experts_roofline"} & got        # no card, no rate


def test_fp8_control_fails_the_checks():
    run = execute(CELL, 2**41 + 7, 0.3, False, proc_start=time.perf_counter(), device="cpu",
                  overrides=OVERRIDES)
    checks, _ = run.system.judge(run, False, lambda s: None)
    ctrl = run.system.control_checks(run, "fp8_e4m3")
    assert checks_pass(checks), checks
    assert {k: {b for b in c if b != "value"} for k, c in ctrl.items()} == {
        k: {b for b in c if b != "value"} for k, c in checks.items()}
    assert not checks_pass(ctrl), ctrl


def _altered(serve):
    sample = serve.sample_tokens

    def broken(*a, **kw):
        tok, done = sample(*a, **kw)
        tok = tok.clone()
        tok[0] = (tok[0] + 1) % 512
        return tok, done
    return serve, "sample_tokens", broken


def _half_left_out(serve):
    decode = serve.decode

    def broken(*a, **kw):
        logits, cache = decode(*a, **kw)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h].mean(0, keepdim=True).expand(
            logits.shape[0] - h, -1)]), cache
    return serve, "decode", broken


def _cache_unchanged(serve):
    from repro_torch.models import mla

    inner = mla.mla_decode

    def broken(p, x, cache, *a, **kw):
        out, _ = inner(p, x, {k: v.clone() for k, v in cache.items()}, *a, **kw)
        return out, cache
    return mla, "mla_decode", broken


def _one_expert_dropped(serve):
    from repro_torch.models import moe

    inner = moe.grouped_swiglu

    def broken(xs, ends, *w):
        y = inner(xs, ends, *w)
        return torch.where((torch.arange(len(y)) < ends[0])[:, None], 0, y)
    return moe, "grouped_swiglu", broken


def _late_cache_unwritten(serve):
    """The latent cache left unwritten past the warm-up call's positions."""
    from repro_torch.models import mla

    inner = mla.mla_decode

    def broken(p, x, cache, pos, *a, **kw):
        if pos < 12:
            return inner(p, x, cache, pos, *a, **kw)
        out, _ = inner(p, x, {k: v.clone() for k, v in cache.items()}, pos, *a, **kw)
        return out, cache
    return mla, "mla_decode", broken


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _cache_unchanged,
                                   _one_expert_dropped],
                         ids=["altered", "half_left_out", "cache_unchanged", "expert_dropped"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.launch import serve

    mod, name, broken = fault(serve)
    monkeypatch.setattr(mod, name, broken)
    out = _run()
    assert not out["correct"], out["checks"]


def test_a_fault_at_the_windows_positions_alone_fails_the_forced_tokens(monkeypatch):
    """The warm-up call (8 positions) is sound; the window's calls lose their
    cache writes from position 12: the routing-forced reference over the
    window's first call puts its tokens past the margin."""
    from repro_torch.launch import serve

    mod, name, broken = _late_cache_unwritten(serve)
    monkeypatch.setattr(mod, name, broken)
    out = _run()
    c = out["checks"]
    assert not out["correct"]
    assert c["max_logit_dev"]["value"] <= c["max_logit_dev"]["limit"]     # the warm-up passes
    assert c["tokens_off_margin"]["value"] > 0, c
