"""The Kimi Linear decode cell on the CPU at a small size: the
configuration against the program's arch, the yardstick's bytes and
FLOPs by hand, the system's facts into its metrics, the cell run through
the harness at a share of the experts (4 of 8, from expert 2), the float8
control, and the timed path broken underneath coming out not correct."""

import json
import time

import numpy as np
import pytest
import torch

from harness import kimi_linear_reference as ref_mod
from harness import kimi_linear_yardstick as yard
from harness.cell import ROOT, Record, checks_pass, execute, reader, run_cell, system
from harness.trace import TraceData

CELL = "kimi-linear-decode"
#: Kimi Linear at the tier-1 tests' small size: 4 layers (KDA with a dense
#: SwiGLU, MLA, KDA, MLA), d 64, 4 heads, KDA heads of 16, MLA nope 16 /
#: rope 8 / v 16 and a latent of 32, experts 2-5 of 8 held, top 3 of width
#: 32, 1 shared, vocab 512; the recorder armed for the warm-up's 4 + 4
#: decode steps and the window's first call's 8 + 16.
REDUCED = {"num_hidden_layers": 4, "hidden_size": 64, "num_attention_heads": 4,
           "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16, "num_experts": 4, "experts_routed": 8,
           "first_expert_held": 2, "num_experts_per_token": 3, "moe_intermediate_size": 32,
           "intermediate_size": 128, "vocab_size": 512, "route_steps": 32,
           "linear_attn_config": {"full_attn_layers": [2, 4], "head_dim": 16,
                                  "kda_layers": [1, 3], "num_heads": 4,
                                  "short_conv_kernel_size": 4}}
TRAFFIC = {"batch": 4, "prompt": 8, "gen": 16, "max_seq": 24, "warm_prompt": 4, "warm_gen": 4,
           "trace_prompt": 2, "trace_gen": 2}
OVERRIDES = {"cfg": REDUCED, "traffic": TRAFFIC}
CARD = {"sms": 132, "max_sm_clock_mhz": 1980.0, "hbm_bytes_per_s": 3.35e12}
BF16 = 132 * 1980e6 * 4096


def _file():
    return json.loads((ROOT / "portbench/configs/kimi-linear-48b-a3b.json").read_text())


def _cfg(**kw):
    cfg = _file()
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


def test_the_configuration_holds_the_catalog_and_configures_the_arch():
    from dataclasses import replace

    from repro_torch.configs import get_config

    cfg = _file()
    mod = system(ROOT, cfg)
    assert mod.model_config(cfg) == replace(get_config(cfg["arch"]), n_experts_held=64)
    catalog = {"first_k_dense_replace": 1, "head_dim": 72, "hidden_size": 2304,
               "intermediate_size": 9216, "kv_lora_rank": 512, "num_experts": 64,
               "moe_intermediate_size": 1024, "num_experts_per_token": 8,
               "num_hidden_layers": 27, "num_attention_heads": 32, "vocab_size": 163840,
               "routed_scaling_factor": 2.446, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
               "v_head_dim": 128, "rope_theta": 10000, "num_shared_experts": 1}
    assert {k: cfg[k] for k in catalog} == catalog and cfg["experts_routed"] == 256
    with pytest.raises(KeyError):
        mod.model_config(dict(cfg, arch="no-such-arch"))
    with pytest.raises(ValueError):
        mod.model_config(dict(cfg, q_lora_rank=1536))


def test_the_yardstick_by_hand():
    cfg = _cfg()
    d, h, r, nope, rope, v, hk, dk = 64, 4, 32, 16, 8, 16, 4, 16
    mla = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v) + h * v * d
    kda = 4 * d * hk * dk + 2 * (d + hk * dk) * dk + d * hk
    moe = d * 8 + 3 * (3 * 4 / 8) * d * 32 + 3 * d * 32         # 3 of 8 chosen, 4 held
    active = 2 * mla + 2 * kda + 3 * d * 128 + 3 * moe + d * 512
    assert yard.active_matrix_params(cfg) == pytest.approx(active, rel=1e-15)
    assert yard.kda_state_flops(cfg) == 2 * 8 * hk * dk * dk
    per_pos = 2 * (2 * h * (nope + rope) + 2 * h * v)             # two MLA layers
    want = 2 * ((2 * active + 2 * 8 * hk * dk * dk) * 20 + per_pos * sum(range(1, 21)))
    assert yard.call_flops(cfg, 2, 20) == pytest.approx(want, rel=1e-12)
    nbytes = 4 * 5 * hk * (2 * dk * dk + 5 * dk + 1)
    assert yard.kda_launch_bytes(cfg, 5) == nbytes
    assert yard.kda_launch_flops(cfg, 5) == 8 * 5 * hk * dk * dk
    assert yard.kda_bound_s(cfg, 5, 3, CARD) == pytest.approx(3 * nbytes / 3.35e12)
    # The FLOPs are float32 on the CUDA cores: on a card of one SM at 1 MHz
    # they bind, at 256 a clock and SM (the bf16 tensor cores' rate would
    # make the bound ~15 times too short).
    slow = dict(CARD, sms=1, max_sm_clock_mhz=1.0)
    assert yard.kda_bound_s(cfg, 5, 3, slow) == pytest.approx(3 * 8 * 5 * hk * dk * dk / 256e6)
    assert yard.fp32_flops_per_s(CARD) == pytest.approx(
        CARD["sms"] * CARD["max_sm_clock_mhz"] * 1e6 * 256)


def test_the_published_sizes_reckon_as_the_cut_does():
    """At the published widths and 256 sequences, a step's 20 launches move
    21.9 GB (the state's 10.74 GB read and written, the inputs and outputs
    0.42 GB): 6.54 ms at 3.35 TB/s."""
    cfg = _file()
    assert yard.kda_launch_bytes(cfg, 256) * 20 == pytest.approx(21.9e9, rel=0.01)
    assert yard.kda_bound_s(cfg, 256, 20, CARD) == pytest.approx(6.5358e-3, rel=1e-4)
    assert ref_mod.layer_kinds(cfg).count("kda") == 20


def test_the_systems_facts_reach_its_metrics():
    cfg = _file()
    ends = np.arange(1, 65, dtype=np.int32) * 8                    # 64 held experts, 8 pairs each
    tr = TraceData(start_us=0.0, end_us=1e5, device=[
        ("void (anonymous namespace)::kda_decode_kernel<128>(float*, ...)", 0, 400),
        ("void (anonymous namespace)::kda_decode_kernel<128>(float*, ...)", 500, 880),
        ("cutlass::device_kernel<...GroupProblemShape...>", 1000, 1300),
        ("nvjet_tst_128x16", 1300, 1400)], host=[("decode.replay", 10, 20)])
    rec = Record(attempted=1, failed=0, missing=0, answers=[], window_s=10.0, trace=tr,
                 cfg=cfg, card=CARD,
                 facts={"steps_in_window": 4 * 256, "call_shape": (256, 128, 128),
                        "traced_steps": 2, "expert_counts": [ends, ends]})
    assert reader(ROOT, "kda.state_roofline")(rec) == pytest.approx(
        100 * yard.kda_bound_s(cfg, 256, 2, CARD) / 780e-6)
    assert reader(ROOT, "mfu.decode_kda")(rec) == pytest.approx(
        100 * 4 * yard.call_flops(cfg, 256, 256) / (10.0 * BF16))
    assert reader(ROOT, "moe.experts_roofline")(rec) is not None
    # A program without the kernel's rows, or a run without a card: no reading.
    bare = Record(attempted=1, failed=0, missing=0, answers=[], window_s=10.0, cfg=cfg,
                  card=CARD, trace=TraceData(0.0, 1e5, device=[("nvjet", 0, 10)], host=[]),
                  facts={"traced_steps": 2, "call_shape": (256, 128, 128)})
    assert reader(ROOT, "kda.state_roofline")(bare) is None
    for name in ("kda.state_roofline", "mfu.decode_kda"):
        assert reader(ROOT, name)(Record(attempted=1, failed=0, missing=0, answers=[],
                                         window_s=1.0, cfg=cfg, card=None, trace=tr,
                                         facts=rec.facts)) is None
    moon = json.loads((ROOT / "portbench/configs/moonlight-16b-a3b.json").read_text())
    assert reader(ROOT, "mfu.decode_kda")(Record(
        attempted=1, failed=0, missing=0, answers=[], window_s=1.0, cfg=moon, card=CARD,
        trace=tr, facts=rec.facts)) is None


def test_the_cell_is_correct_and_reads_its_metrics():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    c = out["checks"]
    assert c["steps_compared"]["value"] == 8 and c["tokens_off_margin"]["value"] == 0
    assert c["forced_tokens_compared"]["value"] == 4 * (4 + 16)
    out = _run(trace=True)
    assert out["correct"]
    got = set(out["metrics"])
    assert {"decode.ms_per_step", "decode.replay_share"} <= got
    assert not {"mfu.decode_kda", "kda.state_roofline"} & got        # no card, no rate


def test_fp8_control_fails_the_checks():
    run = execute(CELL, 2**41 + 7, 0.3, False, proc_start=time.perf_counter(), device="cpu",
                  overrides=OVERRIDES)
    checks, _ = run.system.judge(run, False, lambda s: None)
    ctrl = run.system.control_checks(run, "fp8_e4m3")
    assert checks_pass(checks), checks
    assert {k: {b for b in c if b != "value"} for k, c in ctrl.items()} == {
        k: {b for b in c if b != "value"} for k, c in checks.items()}
    assert not checks_pass(ctrl), ctrl


def _state_not_carried():
    from repro_torch.models import kda

    inner = kda.kda_decode_step
    return kda, "kda_decode_step", lambda s, *a: inner(torch.zeros_like(s), *a)


def _decay_dropped():
    from repro_torch.models import kda

    inner = kda.kda_decode_step
    return kda, "kda_decode_step", lambda s, q, k, v, g, b: inner(s, q, k, v, 0 * g, b)


def _conv_unshifted():
    """The convolution's inputs never written past the first step."""
    from repro_torch.models import kda

    inner = kda.kda_decode

    def broken(p, x, cache, cfg):
        out, _ = inner(p, x, dict(cache, conv=cache["conv"].clone()), cfg)
        return out, cache
    return kda, "kda_decode", broken


def _latent_unwritten():
    from repro_torch.models import mla

    inner = mla.mla_decode

    def broken(p, x, cache, *a, **kw):
        out, _ = inner(p, x, {k: v.clone() for k, v in cache.items()}, *a, **kw)
        return out, cache
    return mla, "mla_decode", broken


def _absent_expert_counted():
    """Every pair's product added, those of the experts not held too (on the
    held stack's first expert)."""
    from repro_torch.models import moe

    inner = moe.grouped_swiglu

    def broken(xs, ends, *w):
        return inner(xs, torch.full_like(ends, xs.shape[0]), *w)
    return moe, "grouped_swiglu", broken


@pytest.mark.parametrize("fault", [_state_not_carried, _decay_dropped, _conv_unshifted,
                                   _latent_unwritten, _absent_expert_counted],
                         ids=["state_not_carried", "decay_dropped", "conv_unshifted",
                              "latent_unwritten", "absent_expert_counted"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    mod, name, broken = fault()
    monkeypatch.setattr(mod, name, broken)
    out = _run()
    assert not out["correct"], out["checks"]
