"""The decode step's CUDA graph on the card, on the reduced h2o-danube
(bf16, a ring of 16 wrapped over 24 positions) and the reduced Moonlight
(latent attention, dropless experts): graphed ``generate`` equals eager
``generate`` token for token with bitwise logits at every step, read by
wrapping ``launch.serve.decode`` as the benchmark does; a second call
reuses the graph and still equals a fresh eager call; another batch
captures anew; Moonlight's graphed calls hand ``ROUTING`` bitwise the
eager calls' chosen experts for each step and layer and, under a
profiler, their group ends, with the capture and every replay under
``set_sync_debug_mode("error")``; the position as a tensor issues the
int's kernels and, in an attention layer, its slot's remainder, and the
profiler sees a replay's kernels.  They need
a CUDA device and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_decode_graph_card.py
"""

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.prng import prng_key
from repro_torch.launch import serve
from repro_torch.launch.specs import model_decls
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import ROUTING
from repro_torch.models.base import init_params
from repro_torch.train import decode_graph

B, PROMPT, GEN, MAX_SEQ = 8, 8, 16, 24


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    decode_graph.drop()
    yield torch.device("cuda", 0)
    decode_graph.drop()


def _model(arch, card):
    cfg = reduced_config(get_config(arch))
    return cfg, init_params(model_decls(cfg, fan_in=True), prng_key(0, card))


def _prompts(cfg, card, seed, b=B):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, PROMPT), device=card, generator=g,
                         dtype=torch.int32)


def _generate(cfg, params, prompts):
    """(tokens, each step's logits [B, steps, vocab]) of one call, the
    logits as ``generate`` gets them from ``serve.decode``."""
    steps, inner = [], serve.decode

    def kept(*args, **kw):
        logits, cache = inner(*args, **kw)
        steps.append(logits.clone())
        return logits, cache

    serve.decode = kept
    try:
        tokens = serve.generate(cfg, params, prompts, GEN, max_seq=MAX_SEQ)
    finally:
        serve.decode = inner
    return tokens, torch.stack(steps, 1)


def _eager(monkeypatch, cfg, params, prompts):
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "graphed", lambda *a, **kw: False)
        return _generate(cfg, params, prompts)


def _counts():
    return {k: decode_graph.COUNTS[k] for k in ("captures", "replays", "eager", "routing_copies")}


@pytest.mark.card
def test_graphed_generate_is_bitwise_the_eager_one_and_is_reused(card, monkeypatch):
    cfg, params = _model("h2o-danube-1.8b", card)
    assert decode_graph.graphed(cfg, card)
    start = _counts()
    for call, seed in enumerate((1, 2)):
        prompts = _prompts(cfg, card, seed)
        want_tokens, want_logits = _eager(monkeypatch, cfg, params, prompts)
        got_tokens, got_logits = _generate(cfg, params, prompts)
        assert got_logits.shape == (B, PROMPT + GEN, cfg.vocab_size)
        assert torch.equal(got_tokens, want_tokens), call
        assert torch.equal(got_logits, want_logits), call
        now = _counts()
        assert now["captures"] - start["captures"] == 1, call     # the second call reuses it
        assert now["replays"] - start["replays"] == (call + 1) * (PROMPT + GEN)
        assert now["eager"] - start["eager"] == (call + 1) * (PROMPT + GEN)
    _generate(cfg, params, _prompts(cfg, card, 3, b=B // 2))
    assert _counts()["captures"] - start["captures"] == 2            # another batch


def _no_sync_steps(monkeypatch):
    """Every graphed step (the capture and each replay, with its routing
    copy-out) under ``set_sync_debug_mode("error")``."""
    inner = decode_graph.DecodeGraph.step

    def step(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(decode_graph.DecodeGraph, "step", step)


def _chosen_ids(chosen):
    return [[(layer, ids.cpu()) for layer, ids in step] for step in chosen]


@pytest.mark.card
def test_graphed_moonlight_is_bitwise_the_eager_one_with_its_routing(card, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    cfg, params = _model("moonlight-16b-a3b", card)
    assert decode_graph.graphed(cfg, card)
    moe_layers = tfm.dropless_layers(cfg)
    steps = PROMPT + GEN
    _no_sync_steps(monkeypatch)
    start = _counts()
    for call, seed in enumerate((4, 5)):
        prompts = _prompts(cfg, card, seed)
        ROUTING.arm(steps)
        want_tokens, want_logits = _eager(monkeypatch, cfg, params, prompts)
        want_chosen = _chosen_ids(ROUTING.take_chosen())
        ROUTING.arm(steps)
        got_tokens, got_logits = _generate(cfg, params, prompts)
        got_chosen = _chosen_ids(ROUTING.take_chosen())
        assert torch.equal(got_tokens, want_tokens), call
        assert torch.equal(got_logits, want_logits), call
        assert len(got_chosen) == len(want_chosen) == steps, call
        for mine, eager in zip(got_chosen, want_chosen):
            assert [layer for layer, _ in mine] == [layer for layer, _ in eager] == moe_layers
            assert all(torch.equal(a, b) for (_, a), (_, b) in zip(mine, eager)), call
        now = _counts()
        assert now["captures"] - start["captures"] == 1, call     # the second call reuses it
        assert now["replays"] - start["replays"] == (call + 1) * steps
        assert now["routing_copies"] - start["routing_copies"] == (call + 1) * steps
        assert now["eager"] - start["eager"] == (call + 1) * steps
    counts = []
    for graph in (False, True):
        ROUTING.arm_counts()
        with profile(activities=[ProfilerActivity.CPU]):
            if graph:
                tokens, _ = _generate(cfg, params, _prompts(cfg, card, 6))
            else:
                tokens, _ = _eager(monkeypatch, cfg, params, _prompts(cfg, card, 6))
        counts.append([c.cpu() for c in ROUTING.take_counts()])
    assert len(counts[0]) == len(counts[1]) == steps * len(moe_layers)
    assert all(torch.equal(a, b) for a, b in zip(*counts))
    assert _counts()["captures"] - start["captures"] == 1


def _device_ops(fn) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events() if getattr(ev, "device_type", None) == DeviceType.CUDA
               and not ev.name.startswith("cuda"))


@pytest.mark.card
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "moonlight-16b-a3b"])
def test_the_tensor_position_issues_the_int_positions_kernels_and_a_replay_shows_them(card, arch):
    cfg, params = _model(arch, card)
    cache = tfm.init_decode_cache(B, cfg, MAX_SEQ, card)
    tok = _prompts(cfg, card, 5)[:, :1]
    pos = torch.full((), 20, dtype=torch.int64, device=card)
    tfm.decode_step(params, tok, cache, 19, cfg)                     # lazy set-up
    tfm.decode_step(params, tok, cache, pos, cfg)
    by_int = _device_ops(lambda: tfm.decode_step(params, tok, cache, 20, cfg))
    by_tensor = _device_ops(lambda: tfm.decode_step(params, tok, cache, pos, cfg))
    # An attention layer that the GQA decode kernel takes (a whole bf16
    # cache) reduces a tensor position to its slot on the card, an int on
    # the host: one kernel more a layer; the rest are the int's.
    slots = tfm.layer_kinds(cfg).count("attn")
    assert by_tensor - by_int == slots and by_int > 0, (by_int, by_tensor, slots)
    held = decode_graph.holder(params, cfg, B, MAX_SEQ, card)
    held.step(tok, 0)                                                # the capture
    # The token copy, the position fill and the logits' copy beside the step
    # (the recorder is not armed: no routing is copied).
    assert _device_ops(lambda: held.step(tok, 1)) == by_tensor + 3
