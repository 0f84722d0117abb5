"""The port's Kimi Linear (a port-only arch: Kimi Delta Attention beside
NoPE latent attention, sigmoid-routed experts held in part) against the
benchmark's plain float32 reference ``portbench/harness/
kimi_linear_reference.py``, at a small size (4 layers: KDA with a dense
SwiGLU, MLA, KDA, MLA; d 64, 4 heads, KDA heads of 16 with a short conv
of 4, MLA nope 16 / rope 8 / v 16 and a latent of 32; 8 experts routed,
top 3, of width 32, 1 shared; vocab 512) on the reference's seeded weights
(``make_weights``), which the program's tree holds as they are.

The full forward and a prompt then greedy decoding through the hybrid
cache (the latent ``{c, k_r}`` and the KDA ``{S, conv}`` side by side) are
held to the reference within 1e-4 in float32 (logits of magnitude ~2-4:
float32 rounding over 4 layers, sums in another order).  A chip's share
of the experts is tied to the uncut layer, the all-held path is held bit
for bit to the dropless path as it was before shares, and planted faults
each fail the comparison.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT / "portbench") not in sys.path:
    sys.path.insert(0, str(_ROOT / "portbench"))

from harness import kimi_linear_reference as ref  # noqa: E402
from harness.cell import _module  # noqa: E402
from repro_torch.configs import ARCHS, PORT_ONLY_ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import kda as kda_mod  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import lm_logits  # noqa: E402
from repro_torch.roofline import flops_estimate, hbm_bytes_estimate  # noqa: E402
from repro_torch.spans import span  # noqa: E402

ARCH = "kimi-linear-48b-a3b"
TOL = dict(rtol=1e-4, atol=1e-4)
_SYS = _module(_ROOT / "portbench" / "systems" / "kimi_linear_decode.py")
_LM = _module(_ROOT / "portbench" / "systems" / "lm_decode.py")

#: The configuration file at the small size; all 8 experts held unless a
#: test holds a share.
SMALL = {"num_hidden_layers": 4, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "num_experts": 8, "experts_routed": 8,
         "num_experts_per_token": 3, "moe_intermediate_size": 32, "intermediate_size": 128,
         "vocab_size": 512, "torch_dtype": "float32",
         "linear_attn_config": {"full_attn_layers": [2, 4], "head_dim": 16,
                                "kda_layers": [1, 3], "num_heads": 4,
                                "short_conv_kernel_size": 4}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(**kw) -> dict:
    cfg = json.loads((_ROOT / "portbench/configs/kimi-linear-48b-a3b.json").read_text())
    cfg.update(SMALL, **kw)
    cfg["assumed"] = dict(cfg["assumed"], router_std=0.3, bias_std=0.1)
    return cfg


def _model(seed=0, **kw):
    """(the program's config, its tree, the reference's keys and weights)."""
    keys = _keys(**kw)
    weights = ref.make_weights(keys, seed, "cpu")
    cfg = _SYS.model_config(keys)
    return cfg, _LM._program_tree(cfg, weights), keys, weights


def _tokens(n=3, s=10, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 512, (n, s)))


def _reference(weights, keys, toks):
    return torch.cat([lg for _, lg in ref.logits_blocks(weights, keys, toks, block=2,
                                                         head_block=2)])


def _decoded(params, cfg, toks):
    cache = tfm.init_decode_cache(toks.shape[0], cfg, toks.shape[1] + 2, "cpu")
    steps = []
    for i in range(toks.shape[1]):
        lg, cache = tfm.decode_step(params, toks[:, i:i + 1].int(), cache, i, cfg)
        steps.append(lg)
    return torch.stack(steps, 1), cache


def test_the_configuration_is_the_registered_arch_with_a_quarter_of_its_experts():
    keys = json.loads((_ROOT / "portbench/configs/kimi-linear-48b-a3b.json").read_text())
    cfg = _SYS.model_config(keys)
    assert cfg == dataclasses.replace(get_config(ARCH), n_experts_held=64)
    assert ARCH in PORT_ONLY_ARCHS and get_config(ARCH) is ARCHS[ARCH]
    kinds = [cfg.pattern_for_layer(i) for i in range(27)]
    assert [i for i, k in enumerate(kinds) if k == "mla"] == [3, 7, 11, 15, 19, 23, 26]
    assert kinds.count("kda") == 20 and not cfg.mla_rope
    assert cfg.n_experts == 256 and cfg.experts_held == 64 and cfg.first_expert_held == 0
    with pytest.raises(ValueError):
        _SYS.model_config(dict(keys, mla_use_nope=False))


def test_kimi_counts_its_matrix_and_embedding_parameters():
    """49,121,476,608 matrix and embedding parameters whole (98 GB in bf16),
    13,788,659,712 with 64 of the 256 experts held; a token's active
    parameters reach 8 experts whole, 2 on average of the 64 held."""
    c = ARCHS[ARCH]
    d, ff, kd, dk = 2304, 1024, 32 * 128, 128
    kda = 4 * d * kd + 2 * (d + kd) * dk + d * 32
    mla = d * 32 * 192 + d * (512 + 64) + 512 * 32 * 256 + 32 * 128 * d
    moe = lambda e: e * 3 * d * ff + 3 * d * ff + d * 256      # noqa: E731
    head = 2 * 163840 * d
    assert c.param_count() == 20 * kda + 7 * mla + 3 * d * 9216 + 26 * moe(256) + head
    assert c.param_count() == 49_121_476_608
    held = dataclasses.replace(c, n_experts_held=64)
    assert held.param_count() == 13_788_659_712
    assert c.active_param_count() == c.param_count() - 26 * 248 * 3 * d * ff
    assert held.active_param_count() == held.param_count() - 26 * 62 * 3 * d * ff
    keys = json.loads((_ROOT / "portbench/configs/kimi-linear-48b-a3b.json").read_text())
    n = sum(int(np.prod(s)) for name, s, _, kind in ref.leaves(keys)
            if kind in ("matrix", "embed", "router") and not name.endswith("attn.conv"))
    assert n == held.param_count()


def test_kimi_flops_and_bytes_count_kda_layers_and_the_held_experts():
    c = dataclasses.replace(ARCHS[ARCH], n_experts_held=64)
    b, s = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    d, kd, dk = 2304, 4096, 128
    kda = 2.0 * b * (4 * d * kd + 2 * (d + kd) * dk + d * 32) + 8.0 * b * 32 * dk * dk
    mla = (2.0 * b * (d * 32 * 192 + d * 576 + 32 * 128 * d) + 2.0 * b * 32 * 512 * 256
           + 2.0 * b * 32 * s * 576 + 2.0 * b * 32 * s * 512)
    dense = 2.0 * b * 3 * d * 9216
    moe = 2.0 * b * (d * 256 + 3 * 2 * d * 1024 + 3 * d * 1024)     # 8 x 64/256 held
    want = 20 * kda + 7 * mla + dense + 26 * moe + 2.0 * b * d * 163840
    assert flops_estimate(c, SHAPES["decode_32k"]) == want
    state = 8.0 * b * 32 * dk * dk * 20
    latent = 2.0 * b * s * 576 * 7
    assert hbm_bytes_estimate(c, SHAPES["decode_32k"], 1) == (
        2.0 * c.param_count() / 1 * (c.active_param_count() / c.param_count())
        + (latent + state))


def test_forward_equals_the_reference():
    cfg, params, keys, weights = _model(seed=4)
    toks = _tokens(2, 12, seed=5)
    hidden, aux = tfm.forward(params, toks.int(), cfg, remat=False)
    assert float(aux) == 0.0
    torch.testing.assert_close(lm_logits(params["embed"], hidden, cfg),
                               _reference(weights, keys, toks), **TOL)


def test_a_prompt_then_greedy_decoding_through_the_hybrid_cache_equals_the_reference():
    """``generate`` (6 prompt ids, then 8 greedy tokens) on the CPU, its
    logits at every step as it gets them from ``decode``, against the
    reference's forward over the prompt and the tokens it chose."""
    cfg, params, keys, weights = _model(seed=2)
    prompts = _tokens(3, 6, seed=3).int()
    cache = tfm.init_decode_cache(3, cfg, 16, "cpu")
    assert [sorted(c) for c in cache] == [["S", "conv"], ["c", "k_r"]] * 2
    assert cache[0]["S"].shape == (3, 4, 16, 16) and cache[0]["S"].dtype == torch.float32
    assert cache[0]["conv"].shape == (3, 3, 3 * 64) and cache[1]["c"].shape == (3, 16, 32)
    steps, inner = [], serve.decode

    def kept(*a, **kw):
        logits, c = inner(*a, **kw)
        steps.append(logits.clone())
        return logits, c

    serve.decode = kept
    try:
        out = serve.generate(cfg, params, prompts, 8, max_seq=16)
    finally:
        serve.decode = inner
    seqs = torch.cat([prompts, out], 1).long()
    want = _reference(weights, keys, seqs)
    torch.testing.assert_close(torch.stack(steps, 1), want, **TOL)
    assert (want[:, 5:13].argmax(-1) == out.long()).all()


def test_kda_decode_step_by_step_equals_kda_apply():
    cfg, params, _, _ = _model(seed=6)
    p = params["layers"][0]["attn"]
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(1))
    whole = kda_mod.kda_apply(p, x, cfg)
    cache = kda_mod.init_kda_cache(2, cfg)
    state, conv = cache["S"], cache["conv"]
    steps = []
    for t in range(9):
        y, out = kda_mod.kda_decode(p, x[:, t:t + 1], cache, cfg)
        assert out is cache and cache["S"] is state and cache["conv"] is conv   # in place
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=1e-5, atol=1e-5)
    assert float(state.abs().max()) > 0.1


@pytest.mark.parametrize("needs_grad", ["x", "w_qkv", "a_log", "w_beta"])
def test_kda_apply_refuses_to_be_trained_without_a_backward(needs_grad):
    """The recurrence writes its state in place and has no backward: where
    autograd would record it, ``kda_apply`` raises rather than hand back an
    output through which no gradient reaches the layer; under ``no_grad``
    the same inputs run."""
    cfg, params, _, _ = _model(seed=6)
    held = params["layers"][0]["attn"]
    p = {name: held[name] for name in kda_mod.kda_decls(cfg)}
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(1))
    if needs_grad == "x":
        x.requires_grad_(True)
    else:
        p[needs_grad] = p[needs_grad].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        kda_mod.kda_apply(p, x, cfg)
    with torch.no_grad():
        assert kda_mod.kda_apply(p, x, cfg).shape == x.shape


def _share_parts(weights, keys, x, layer):
    """The program's experts layer at each of 4 shares of 2 experts, and
    the uncut reference's layer, on ``x``."""
    parts = []
    for i in range(4):
        kw = dict(num_experts=2, first_expert_held=2 * i)
        cfg = _SYS.model_config(_keys(**kw))
        at = f"layers.{layer}.moe."
        p = {k[len(at):]: v for k, v in weights.items() if k.startswith(at)}
        for name in ("w_gate", "w_up", "w_down"):
            p[name] = p[name][2 * i:2 * i + 2]
        parts.append(moe_mod.dropless_apply(p, x, cfg))
    w = {k[len(f"layers.{layer}."):]: v for k, v in weights.items()
         if k.startswith(f"layers.{layer}.")}
    whole = ref._experts(x, w, keys, layer, 0, None)
    return parts, whole, w


def test_four_expert_shares_add_up_to_the_uncut_layer():
    """Guide section 4: the four 2-of-8 shares' parts, the shared expert
    (which each share adds) counted once, add up to the uncut reference's
    layer; each share's part is the reference's own at that share."""
    _, _, keys, weights = _model(seed=8)
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(9))
    parts, whole, w = _share_parts(weights, keys, x, 1)
    shared = ref._swiglu(x, w["moe.shared_gate"], w["moe.shared_up"], w["moe.shared_down"])
    torch.testing.assert_close(sum(parts) - 3 * shared, whole, **TOL)
    for i, part in enumerate(parts):
        wi = dict(w, **{f"moe.w_{k}": w[f"moe.w_{k}"][2 * i:2 * i + 2]
                        for k in ("gate", "up", "down")})
        own = ref._experts(x, wi, _keys(num_experts=2, first_expert_held=2 * i), 1, 0, None)
        torch.testing.assert_close(part, own, **TOL)
    assert all(float((p - shared).abs().max()) > 1e-3 for p in parts)


def _dropless_before(p, x, cfg):
    """``moe.dropless_apply`` as it was before a chip held a share."""
    shape, d, k = x.shape, x.shape[-1], cfg.n_experts_per_token
    xf = x.reshape(-1, d)
    ids, w = moe_mod.route_sigmoid(p, xf, cfg)
    sorted_ids, order = torch.sort(ids.flatten(), stable=True)
    ends = torch.searchsorted(sorted_ids, torch.arange(cfg.n_experts), right=True,
                              out_int32=True)
    y = moe_mod.grouped_swiglu(xf[order // k], ends, p["w_gate"], p["w_up"], p["w_down"])
    pairs = torch.empty_like(y).index_copy_(0, order, y).view(-1, k, d)
    out = (pairs * w[..., None]).sum(dim=1).to(x.dtype)
    return (out + moe_mod._shared(p, xf)).reshape(shape)


@pytest.mark.parametrize("arch", ["moonlight-16b-a3b", ARCH])
def test_dropless_apply_holding_every_expert_is_bitwise_as_before(arch):
    from repro_torch.core.prng import prng_key
    from repro_torch.launch.specs import model_decls
    from repro_torch.models.base import init_params

    cfg = reduced_config(get_config(arch))
    params = init_params(model_decls(cfg, fan_in=True), prng_key(3, "cpu"))
    p = params["layers"][1]["moe"]
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator().manual_seed(4)).to(cfg.dtype)
    got = moe_mod.dropless_apply(p, x, cfg)
    assert torch.equal(got, _dropless_before(p, x, cfg))
    every = dataclasses.replace(cfg, n_experts_held=cfg.n_experts)
    assert torch.equal(moe_mod.dropless_apply(p, x, every), got)


def _state_not_carried(monkeypatch):
    inner = kda_mod.kda_decode_step
    monkeypatch.setattr(kda_mod, "kda_decode_step",
                        lambda s, *a: inner(torch.zeros_like(s), *a))


def _decay_dropped(monkeypatch):
    inner = kda_mod.kda_decode_step
    monkeypatch.setattr(kda_mod, "kda_decode_step",
                        lambda s, q, k, v, g, b: inner(s, q, k, v, torch.zeros_like(g), b))


def _beta_dropped(monkeypatch):
    inner = kda_mod.kda_decode_step
    monkeypatch.setattr(kda_mod, "kda_decode_step",
                        lambda s, q, k, v, g, b: inner(s, q, k, v, g, torch.ones_like(b)))


def _absent_expert_counted(monkeypatch):
    """The share widened by the absent expert just past it, which runs on a
    copy of the last held expert's weights."""
    inner = moe_mod.dropless_apply

    def broken(p, x, cfg, **kw):
        q = {k: p[k] for k in ("router", "router_bias", "shared_gate", "shared_up",
                               "shared_down")}
        q.update({k: torch.cat([p[k], p[k][-1:]]) for k in ("w_gate", "w_up", "w_down")})
        return inner(q, x, dataclasses.replace(cfg, n_experts_held=cfg.experts_held + 1), **kw)
    monkeypatch.setattr(moe_mod, "dropless_apply", broken)


def _rotated_under_nope(monkeypatch):
    inner = mla_mod._project
    monkeypatch.setattr(mla_mod, "_project", lambda p, x, cfg, rotate: inner(
        p, x, dataclasses.replace(cfg, mla_rope=True), rotate))


@pytest.mark.parametrize("fault", [_state_not_carried, _decay_dropped, _beta_dropped,
                                   _absent_expert_counted, _rotated_under_nope],
                         ids=["state_not_carried", "decay_dropped", "beta_dropped",
                              "absent_expert_counted", "rotated_under_nope"])
def test_a_planted_fault_fails_the_comparison(fault, monkeypatch):
    """Decoding a held share (experts 2-5 of 8) through the hybrid cache
    against the reference at the same share: sound within 1e-4, and each
    planted fault far past it."""
    cfg, params, keys, weights = _model(seed=10, num_experts=4, first_expert_held=2)
    toks = _tokens(3, 10, seed=11)
    want = _reference(weights, keys, toks)
    got, _ = _decoded(params, cfg, toks)
    torch.testing.assert_close(got, want, **TOL)
    fault(monkeypatch)
    bad, _ = _decoded(params, cfg, toks)
    assert float((bad - want).abs().max()) > 100 * TOL["atol"]


def test_the_decode_step_opens_the_kda_span():
    from torch.profiler import ProfilerActivity, profile

    cfg, params, _, _ = _model()
    cache = tfm.init_decode_cache(2, cfg, 4, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tfm.decode_step(params, torch.zeros((2, 1), dtype=torch.int32), cache, 0, cfg)
    names = {e.name for e in prof.events()}
    assert {"kda.attend", "mla.attend", "moe.route", "moe.experts", "moe.shared"} <= names
    with span("kda.attend"):
        pass


def test_routing_records_global_ids_and_the_held_groups_ends():
    """With experts 2-5 of 8 held, the recorder keeps the router's own ids
    (0-7) and, under a profiler, the held experts' 4 group ends, whose last
    is the pairs routed to them."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params, _, _ = _model(seed=12, num_experts=4, first_expert_held=2)
    toks = _tokens(2, 3, seed=13).int()
    cache = tfm.init_decode_cache(2, cfg, 4, "cpu")
    moe_mod.ROUTING.arm(1)
    moe_mod.ROUTING.arm_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        tfm.decode_step(params, toks[:, :1], cache, 0, cfg)
    (step,) = moe_mod.ROUTING.take_chosen()
    counts = moe_mod.ROUTING.take_counts()
    assert [layer for layer, _ in step] == [1, 2, 3] and len(counts) == 3
    for (_, ids), ends in zip(step, counts):
        assert ids.shape == (2, 3) and ends.shape == (4,)
        assert int(ends[-1]) == int(((ids >= 2) & (ids < 6)).sum())
