"""The LM decode cell on the CPU at a reduced size: the plain reference
against the port's decode entry, the cell run through the harness, the
float8 control, and the timed path broken underneath (a token altered
where it is produced, half of the batch left out, a decode step that
leaves its cache unchanged) coming out not correct."""

import json
import time

import numpy as np
import pytest
import torch

from harness import lm_reference, lm_yardstick
from harness.cell import ROOT, checks_pass, execute, run_cell, system

CELL = "danube-decode"
#: The reduced h2o-danube (``configs.reduced_config``: 3 layers, width 64,
#: window 16) with 2 kv heads for 4 query heads, so that GQA is run.
TRAFFIC = {"batch": 4, "prompt": 8, "gen": 16, "max_seq": 24, "warm_prompt": 4, "warm_gen": 4,
           "trace_prompt": 2, "trace_gen": 2}


def _reduced():
    from repro_torch.configs import get_config, reduced_config

    rc = reduced_config(get_config("h2o-danube-1.8b"))
    keys = ("n_layers", "d_model", "n_heads", "head_dim", "d_ff", "vocab_size", "sliding_window")
    return dict({k: getattr(rc, k) for k in keys}, n_kv_heads=2)


def _cfg(**kw):
    cfg = json.loads((ROOT / "portbench/configs/h2o-danube-1.8b.json").read_text())
    cfg.update(_reduced(), **kw)
    return cfg


OVERRIDES = {"cfg": _reduced(), "traffic": TRAFFIC}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(trace=False, seed=2**33 + 5):
    return run_cell(CELL, seed, 0.4, trace, proc_start=time.perf_counter(), device="cpu",
                    overrides=OVERRIDES, log=lambda s: None)


def test_config_file_states_the_published_widths():
    from repro_torch.configs import get_config

    cfg = json.loads((ROOT / "portbench/configs/h2o-danube-1.8b.json").read_text())
    arch, pub = get_config(cfg["arch"]), cfg["published"]
    for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
              "sliding_window", "rope_theta", "tie_embeddings"):
        assert cfg[k] == getattr(arch, k), k
    assert (pub["num_hidden_layers"], pub["hidden_size"], pub["num_attention_heads"],
            pub["num_key_value_heads"], pub["intermediate_size"], pub["vocab_size"],
            pub["sliding_window"], pub["rms_norm_eps"]) == (
        cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"],
        cfg["vocab_size"], cfg["sliding_window"], cfg["norm_eps"])
    assert cfg["d_model"] // cfg["n_heads"] == cfg["head_dim"]
    n = sum(int(np.prod(s)) for _, s, _ in lm_reference.leaves(cfg))
    assert 1.82e9 < n < 1.84e9          # 1.83 B parameters, 3.7 GB in bf16


def test_port_decode_matches_the_reference_in_float32():
    """``train/serve_step.decode`` step by step from an empty cache (the
    ring of the reduced window wraps) against the reference's full forward
    over the same ids: float32 on both sides, within 1e-4."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.serve_step import decode

    cfg = _cfg(dtype="float32")
    mod = system(ROOT, cfg)
    weights = lm_reference.make_weights(cfg, 11, "cpu")
    mcfg = mod.model_config(cfg)
    params = mod._program_tree(mcfg, weights)
    s = 24
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg["vocab_size"], (3, s)))
    cache = tfm.init_decode_cache(3, mcfg, 20, "cpu")   # a ring of 16 slots
    mine = []
    for i in range(s):
        lg, cache = decode(params, ids[:, i:i + 1].int(), cache, i, mcfg)
        mine.append(lg)
    (_, ref), = lm_reference.logits_blocks(weights, cfg, ids, block=3)
    torch.testing.assert_close(torch.stack(mine, 1), ref, rtol=1e-4, atol=1e-4)


def test_the_cell_is_correct_and_reads_its_metrics():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    c = out["checks"]
    assert c["steps_compared"]["value"] == 8 and c["tokens_off_margin"]["value"] == 0
    assert c["tokens_compared"]["value"] >= 2 * 4 * 16 + 4 * 4
    out = _run(trace=True)
    assert out["correct"] and "decode.ms_per_step" in out["metrics"]
    assert "mfu.decode" not in out["metrics"]       # no card, no rate


def test_fp8_control_fails_the_checks():
    """The control gives the judge's own checks, with the same limits, and
    they fail where the program's pass."""
    run = execute(CELL, 2**33 + 7, 0.3, False, proc_start=time.perf_counter(), device="cpu",
                  overrides=OVERRIDES)
    checks, _ = run.system.judge(run, False, lambda s: None)
    ctrl = run.system.control_checks(run, "fp8_e4m3")
    assert checks_pass(checks), checks
    assert {k: {b for b in c if b != "value"} for k, c in ctrl.items()} == {
        k: {b for b in c if b != "value"} for k, c in checks.items()}
    assert all(ctrl[k][b] == checks[k][b] for k in ctrl for b in ("limit", "min") if b in ctrl[k])
    assert not checks_pass(ctrl), ctrl


def test_control_script_judges_program_and_control_as_a_run_does():
    import control

    out = control.readings(CELL, [2**35 + 1], 0.3, "cpu", ROOT, overrides=OVERRIDES,
                           log=lambda s: None)
    seed = 2**35 + 1
    assert out["program_correct"] and out["program"][seed]["correct"]
    assert out["control_correct_on_any_seed"] == {"fp8_e4m3": False}
    assert not out["control"]["fp8_e4m3"][seed]["correct"]
    assert out["control_min"]["fp8_e4m3"]["token_gap_max"] > out["program_max"]["token_gap_max"]


def test_reference_restores_the_tf32_settings_between_blocks():
    cfg = _cfg(dtype="float32")
    weights = lm_reference.make_weights(cfg, 3, "cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, cfg["vocab_size"], (4, 6)))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for _ in lm_reference.logits_blocks(weights, cfg, ids, block=2):
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _altered(serve):
    sample = serve.sample_tokens

    def broken(*a, **kw):
        tok, done = sample(*a, **kw)
        tok = tok.clone()
        tok[0] = (tok[0] + 1) % 512
        return tok, done
    return "sample_tokens", broken


def _half_left_out(serve):
    decode = serve.decode

    def broken(*a, **kw):
        logits, cache = decode(*a, **kw)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h].mean(0, keepdim=True).expand(
            logits.shape[0] - h, -1)]), cache
    return "decode", broken


def _state_unchanged(serve):
    from repro_torch.models import attention

    inner = attention.decode_attention

    def broken(p, x, k, v, *a, **kw):
        out, _, _ = inner(p, x, k.clone(), v.clone(), *a, **kw)
        return out, k, v
    return None, (attention, "decode_attention", broken)


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _state_unchanged],
                         ids=["altered", "half_left_out", "state_unchanged"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.launch import serve

    name, broken = fault(serve)
    if name is None:
        monkeypatch.setattr(*broken)
    else:
        monkeypatch.setattr(serve, name, broken)
    out = _run()
    assert not out["correct"] and out["checks"]["tokens_off_margin"]["value"] > 0


def test_model_flops_of_a_call():
    cfg = _cfg()
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    hd, h, kv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
    assert lm_yardstick.matrix_params(cfg) == cfg["n_layers"] * per_layer + d * v
    # 20 positions under a window of 16: 1 + 2 + ... + 16, then 16 four times.
    held = sum(range(1, 17)) + 4 * 16
    want = 2 * (2 * lm_yardstick.matrix_params(cfg) * 20 + 4 * cfg["n_layers"] * h * hd * held)
    assert lm_yardstick.call_flops(cfg, 2, 20) == want
    card = {"sms": 132, "max_sm_clock_mhz": 1830.0}
    assert lm_yardstick.bf16_flops_per_s(card) == pytest.approx(989.5e12, rel=1e-3)
