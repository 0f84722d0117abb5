"""The port's latent attention and sigmoid-routed dropless experts
(Moonlight-16B-A3B, a port-only arch) against the plain float32 reference
``tests/_plain_mla_moe.py``, at the reduced size (3 layers: 1 dense + 2
MoE; d 64, 4 heads, nope 16 / rope 8 / v 16, latent 32, 8 experts top-3,
shared width twice an expert's, vocab 512) on seeded weights of each
layer's own fan-in and a correction bias that moves choices.

Decode through the latent cache and ``forward`` are held to the
reference within 1e-4 in float32 (logits of magnitude ~4: float32
rounding over 3 layers and a different order of sums, the absorbed
products among them).  The router's arithmetic is held exactly; the
reference is held to the published implementation (``transformers``'
DeepseekV3ForCausalLM) where that is importable.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import _plain_mla_moe as plain
from repro_torch.configs import ARCHS, PORT_ONLY_ARCHS, get_config, paired_archs, reduced_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.prng import prng_key
from repro_torch.launch.specs import model_decls
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params
from repro_torch.models.layers import lm_logits, rope, rope_pairs
from repro_torch.roofline import flops_estimate, hbm_bytes_estimate
from repro_torch.spans import span

ARCH = "moonlight-16b-a3b"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return dataclasses.replace(reduced_config(get_config(ARCH)), dtype=torch.float32, **kw)


def hf_keys(c) -> dict:
    """The reference's configuration (``config.json`` keys) of a port config."""
    return {"hidden_size": c.d_model, "num_attention_heads": c.n_heads,
            "kv_lora_rank": c.kv_lora_rank, "qk_nope_head_dim": c.qk_nope_head_dim,
            "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim,
            "rope_theta": c.rope_theta, "rms_norm_eps": c.norm_eps,
            "num_hidden_layers": c.n_layers, "first_k_dense_replace": c.first_k_dense,
            "num_experts_per_tok": c.n_experts_per_token, "n_routed_experts": c.n_experts,
            "routed_scaling_factor": c.routed_scaling, "vocab_size": c.vocab_size,
            "intermediate_size": c.d_ff_dense, "moe_intermediate_size": c.d_ff,
            "n_shared_experts": c.d_ff_shared // c.d_ff}


def _model(cfg, seed=0, bias_std=0.3):
    params = init_params(model_decls(cfg, fan_in=True), prng_key(seed, "cpu"))
    gen = torch.Generator().manual_seed(seed)
    for i in range(cfg.first_k_dense, cfg.n_layers):
        moe = params["layers"][i]["moe"]
        moe["router"].copy_(torch.randn(moe["router"].shape, generator=gen))
        moe["router_bias"].copy_(torch.randn(moe["router_bias"].shape, generator=gen) * bias_std)
    return params, dict(params.named_parameters())


def _tokens(n=3, s=10, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 512, (n, s)))


def test_decode_through_the_latent_cache_equals_the_reference_forward():
    cfg = _cfg()
    params, weights = _model(cfg)
    toks = _tokens()
    cache = tfm.init_decode_cache(3, cfg, 12, "cpu")
    assert [sorted(c) for c in cache] == [["c", "k_r"]] * 3
    assert cache[0]["c"].shape == (3, 12, 32) and cache[0]["k_r"].shape == (3, 12, 8)
    steps = []
    for i in range(toks.shape[1]):
        lg, cache = tfm.decode_step(params, toks[:, i:i + 1].int(), cache, i, cfg)
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, 1), plain.logits(weights, hf_keys(cfg), toks),
                               **TOL)


def test_forward_equals_the_reference():
    cfg = _cfg()
    params, weights = _model(cfg, seed=4)
    toks = _tokens(2, 12, seed=5)
    hidden, aux = tfm.forward(params, toks.int(), cfg, remat=False)
    assert float(aux) == 0.0
    torch.testing.assert_close(lm_logits(params["embed"], hidden, cfg),
                               plain.logits(weights, hf_keys(cfg), toks), **TOL)


def test_rope_pairs_rotates_adjacent_pairs_as_the_half_rotation_of_the_deinterleaved_head():
    x = torch.randn(2, 5, 3, 8)
    pos = torch.arange(5).expand(2, 5)
    perm = torch.cat([torch.arange(0, 8, 2), torch.arange(1, 8, 2)])
    torch.testing.assert_close(rope_pairs(x, pos, 50_000.0)[..., perm],
                               rope(x[..., perm], pos, 50_000.0), rtol=0, atol=1e-6)


def _route(cfg, moe, x):
    return moe_mod.route_sigmoid(moe, x, cfg)


def test_the_correction_bias_changes_the_choice_but_not_the_weights():
    cfg = _cfg()
    params, _ = _model(cfg)
    moe = params["layers"][1]["moe"]
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(3))
    ids, w = _route(cfg, moe, x)
    moe["router_bias"].zero_()
    ids0, w0 = _route(cfg, moe, x)
    moved = (torch.sort(ids, -1).values != torch.sort(ids0, -1).values).any(-1)
    assert 0 < int(moved.sum()) < 64
    scores = torch.sigmoid(x @ moe["router"])
    for i, ww in ((ids, w), (ids0, w0)):
        s = scores.gather(-1, i)
        torch.testing.assert_close(ww, s / s.sum(-1, keepdim=True) * cfg.routed_scaling,
                                   rtol=0, atol=0)
    # Where the bias left the choice alone, the weights are the unbiased
    # ones (summed in another order: float32 rounding).
    same = ~moved
    torch.testing.assert_close(torch.sort(w[same], -1).values, torch.sort(w0[same], -1).values,
                               rtol=0, atol=1e-6)


def test_weights_are_normalised_then_scaled():
    cfg = _cfg()
    params, _ = _model(cfg)
    ids, w = _route(cfg, params["layers"][2]["moe"], torch.randn(50, cfg.d_model))
    assert ids.shape == w.shape == (50, 3) and w.dtype == torch.float32
    torch.testing.assert_close(w.sum(-1), torch.full((50,), 2.446), rtol=0, atol=1e-6)
    assert (w > 0).all()


def test_a_batch_routed_wholly_to_one_expert_loses_no_token():
    """Every token routed to experts 5, 6, 7 (a constant feature the router
    weighs by 100 there): the dropless path gives each of the 40 tokens its
    three experts, as the reference does, where the softmax router's
    capacity path (18 slots an expert here) gives 22 of them nothing."""
    cfg = _cfg()
    params, weights = _model(cfg)
    moe = params["layers"][1]["moe"]
    moe["router"].zero_()
    moe["router"][0, 5:] = 100.0
    moe["router_bias"].zero_()
    x = torch.randn(1, 40, cfg.d_model, generator=torch.Generator().manual_seed(8))
    x[..., 0] = 1.0
    ids, _ = _route(cfg, moe, x[0])
    assert (torch.sort(ids, -1).values == torch.tensor([5, 6, 7])).all()
    lw = {k[len("layers.1."):]: v for k, v in weights.items() if k.startswith("layers.1.")}
    got = moe_mod.dropless_apply(moe, x, cfg)
    torch.testing.assert_close(got, plain._moe(x, lw, hf_keys(cfg), None), **TOL)
    assert int((got - moe_mod._shared(moe, x)).abs().sum(-1).eq(0).sum()) == 0
    soft = dataclasses.replace(cfg, router="softmax", n_shared_experts=0)
    p = {k: moe[k] for k in ("router", "w_gate", "w_up", "w_down")}
    y, _ = moe_mod.moe_apply(p, x, soft)
    assert int(y[0].abs().sum(-1).eq(0).sum()) == 40 - int(40 * 3 / 8 * 1.25)


def test_grouped_swiglu_equals_its_plain_twin():
    g = torch.Generator().manual_seed(2)
    e, d, ff, rows = 8, 64, 128, 90
    xs = torch.randn(rows, d, generator=g)
    ids = torch.sort(torch.randint(0, e, (rows,), generator=g)).values
    ids[ids == 3] = 4                                   # one empty group
    ends = torch.searchsorted(ids, torch.arange(e), right=True, out_int32=True)
    ws = [torch.randn(e, d, ff, generator=g), torch.randn(e, d, ff, generator=g),
          torch.randn(e, ff, d, generator=g)]
    torch.testing.assert_close(moe_mod.grouped_swiglu(xs, ends, *ws),
                               moe_mod.grouped_swiglu_plain(xs, ends, *ws), rtol=1e-4, atol=1e-3)


def test_routing_record_keeps_the_armed_steps_then_goes_quiet_and_counts_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    params, _ = _model(cfg)
    toks = _tokens(2, 6)
    cache = tfm.init_decode_cache(2, cfg, 8, "cpu")
    moe_mod.ROUTING.arm(3)
    for i in range(5):
        _, cache = tfm.decode_step(params, toks[:, i:i + 1].int(), cache, i, cfg)
    chosen = moe_mod.ROUTING.take_chosen()
    assert [[layer for layer, _ in step] for step in chosen] == [[1, 2]] * 3
    assert all(ids.shape == (2, 3) for step in chosen for _, ids in step)
    with profile(activities=[ProfilerActivity.CPU]):  # unarmed: nothing kept
        tfm.decode_step(params, toks[:, 5:6].int(), cache, 5, cfg)
    assert moe_mod.ROUTING.take_counts() == []
    moe_mod.ROUTING.arm_counts()
    _, cache = tfm.decode_step(params, toks[:, 5:6].int(), cache, 5, cfg)
    assert moe_mod.ROUTING.counts == []              # armed, but no profiler ran
    with profile(activities=[ProfilerActivity.CPU]):
        tfm.decode_step(params, toks[:, 5:6].int(), cache, 5, cfg)
    counts = moe_mod.ROUTING.take_counts()
    assert len(counts) == 2 and all(int(c[-1]) == 2 * 3 for c in counts)
    assert not moe_mod.ROUTING.counting and moe_mod.ROUTING.take_chosen() == []


def _span_names(cfg, params, batch):
    from torch.profiler import ProfilerActivity, profile

    cache = tfm.init_decode_cache(batch, cfg, 4, "cpu")
    tok = torch.zeros((batch, 1), dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tfm.decode_step(params, tok, cache, 0, cfg)
    return {e.name for e in prof.events()}


def test_the_decode_step_opens_its_spans_and_a_dense_decoder_none_of_them():
    cfg = _cfg()
    params, _ = _model(cfg)
    new = {"mla.attend", "moe.route", "moe.experts", "moe.shared"}
    assert new <= _span_names(cfg, params, 2)
    dense = dataclasses.replace(reduced_config(get_config("h2o-danube-1.8b")), dtype=torch.float32)
    dp = init_params(model_decls(dense), prng_key(0, "cpu"))
    assert not new & _span_names(dense, dp, 2)
    with span("mla.attend"):
        pass


def test_moonlight_counts_its_matrix_and_embedding_parameters():
    """15,959,982,080 matrix and embedding parameters (27 layers of MLA,
    one dense SwiGLU of 11,264, 26 layers of 64 experts, 2 shared and a
    router; embedding and untied head), 2,579,103,744 active matrix
    parameters a token (6 experts; the head, not the embedding lookup).
    Norms and the router's correction bias are not counted, as no arch
    counts its norms."""
    c = ARCHS[ARCH]
    assert c.param_count() == 15_959_982_080
    assert c.active_param_count() - c.vocab_size * c.d_model == 2_579_103_744
    assert sum(p.numel() for n, p in tfm_abstract(c) if not n.endswith(("scale", "router_bias"))
               ) == 15_959_982_080
    assert [c.pattern_for_layer(i) for i in range(3)] == ["mla"] * 3
    assert [c.is_moe_layer(i) for i in range(3)] == [False, True, True]


def tfm_abstract(cfg):
    from repro_torch.launch.specs import abstract_model

    return list(abstract_model(cfg).named_parameters())


def test_moonlight_flops_and_bytes_count_latent_attention_dense_layer_and_shared_experts():
    c = ARCHS[ARCH]
    d, h, r, nope, rope_d, v = 2048, 16, 512, 128, 64, 128
    qk = nope + rope_d
    proj = d * h * qk + d * (r + rope_d) + r * h * (nope + v) + h * v * d
    dense = 3 * d * 11264
    moe = d * 64 + 6 * 3 * d * 1408 + 3 * d * 2816
    b, s = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    # Decode, absorbed: projections, q_nope W_UK, (P c) W_UV, scores and
    # weighted sum over the latent and rotary key of every held position.
    absorbed = 2.0 * b * (d * h * qk + d * (r + rope_d) + h * v * d) + 2.0 * b * h * r * (nope + v)
    att = 2.0 * b * h * s * (r + rope_d) + 2.0 * b * h * s * r
    want = 27 * (absorbed + att) + 2.0 * b * dense + 26 * 2.0 * b * moe + 2.0 * b * d * 163840
    assert flops_estimate(c, SHAPES["decode_32k"]) == want
    # Prefill: the projections' full form and the chunked score products.
    bp, sp = SHAPES["prefill_32k"].global_batch, SHAPES["prefill_32k"].seq_len
    want = (27 * (2.0 * bp * sp * proj + 2.0 * bp * h * sp * sp * (qk + v))
            + 2.0 * bp * sp * dense + 26 * 2.0 * bp * sp * moe + 2.0 * bp * d * 163840)
    assert flops_estimate(c, SHAPES["prefill_32k"]) == want
    latent = 2.0 * b * s * (r + rope_d) * 27 / 1
    assert hbm_bytes_estimate(c, SHAPES["decode_32k"], 1) == (
        2.0 * c.param_count() / 1 * (c.active_param_count() / c.param_count()) + latent)


def test_port_only_archs_are_registered_and_named():
    assert PORT_ONLY_ARCHS == (ARCH, "kimi-linear-48b-a3b")
    assert get_config(ARCH) is ARCHS[ARCH]
    assert sorted(paired_archs() + list(PORT_ONLY_ARCHS)) == sorted(ARCHS)


@pytest.fixture
def hf():
    # transformers loads TensorFlow and JAX where installed unless told not
    # to; this test needs its PyTorch model alone.
    for flag in ("USE_TF", "USE_FLAX", "USE_JAX"):
        os.environ.setdefault(flag, "0")
    return pytest.importorskip("transformers")


def test_the_plain_reference_equals_the_published_implementation(hf):
    """``transformers``' DeepseekV3ForCausalLM (eager attention, float32,
    ``rope_interleave``) on the same tiny weights: the plain reference's
    logits within 1e-5."""
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    cfg = _cfg()
    _, weights = _model(cfg, seed=6, bias_std=0.3)
    keys = hf_keys(cfg)
    hc = DeepseekV3Config(**keys, num_key_value_heads=cfg.n_heads, q_lora_rank=None,
                          n_group=1, topk_group=1, norm_topk_prob=True, rope_interleave=True,
                          tie_word_embeddings=False, attention_bias=False,
                          max_position_embeddings=64, hidden_act="silu",
                          attn_implementation="eager")
    model = DeepseekV3ForCausalLM(hc).float().eval()
    sd = {"model.embed_tokens.weight": weights["embed.tok"],
          "lm_head.weight": weights["embed.head"].T, "model.norm.weight": weights["final_norm.scale"]}
    for i in range(cfg.n_layers):
        at, hf_at = f"layers.{i}.", f"model.layers.{i}."
        sd.update({hf_at + "input_layernorm.weight": weights[at + "attn_norm.scale"],
                   hf_at + "post_attention_layernorm.weight": weights[at + "mlp_norm.scale"],
                   hf_at + "self_attn.q_proj.weight": weights[at + "attn.wq"].T,
                   hf_at + "self_attn.kv_a_proj_with_mqa.weight": weights[at + "attn.wkv_a"].T,
                   hf_at + "self_attn.kv_a_layernorm.weight": weights[at + "attn.kv_norm.scale"],
                   hf_at + "self_attn.kv_b_proj.weight": weights[at + "attn.wkv_b"].T,
                   hf_at + "self_attn.o_proj.weight": weights[at + "attn.wo"].T})
        if i < cfg.first_k_dense:
            for k in ("gate", "up", "down"):
                sd[hf_at + f"mlp.{k}_proj.weight"] = weights[at + f"mlp.w_{k}"].T
            continue
        sd[hf_at + "mlp.gate.weight"] = weights[at + "moe.router"].T
        sd[hf_at + "mlp.gate.e_score_correction_bias"] = weights[at + "moe.router_bias"]
        for k in ("gate", "up", "down"):
            sd[hf_at + f"mlp.shared_experts.{k}_proj.weight"] = weights[at + f"moe.shared_{k}"].T
            for e in range(cfg.n_experts):
                sd[hf_at + f"mlp.experts.{e}.{k}_proj.weight"] = weights[at + f"moe.w_{k}"][e].T
    missing, unexpected = model.load_state_dict({k: v.contiguous() for k, v in sd.items()},
                                                strict=False)
    assert not unexpected and not [m for m in missing if "rotary" not in m]
    toks = _tokens(2, 9, seed=7)
    with torch.no_grad():
        want = model(input_ids=toks).logits
    torch.testing.assert_close(plain.logits(weights, keys, toks), want, rtol=1e-5, atol=1e-5)
