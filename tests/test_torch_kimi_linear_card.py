"""Kimi Linear on the card: the KDA decode kernel (``csrc/kda_decode.cu``)
against the torch recurrence, and the decode step's CUDA graph on the
reduced Kimi Linear in bf16 with a share of its experts held (experts 2-5
of 8): graphed ``generate`` equals eager ``generate`` bitwise in logits,
tokens and chosen experts, with the capture and every replay under
``set_sync_debug_mode("error")``; a second call reuses the graph, its
states zeroed, and still equals a fresh eager call.  They need a CUDA
device and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_kimi_linear_card.py
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.prng import prng_key
from repro_torch.kernels import kda as kda_kernels
from repro_torch.launch import serve
from repro_torch.launch.specs import model_decls
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params
from repro_torch.models.moe import ROUTING
from repro_torch.train import decode_graph

B, PROMPT, GEN, MAX_SEQ = 8, 8, 16, 24


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    decode_graph.drop()
    yield torch.device("cuda", 0)
    decode_graph.drop()


def _inputs(card, b, h, dk, seed):
    g = torch.Generator(device=card).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, device=card, generator=g)

    q, k = (t / t.norm(dim=-1, keepdim=True) for t in (r(b, h, dk), r(b, h, dk)))
    g_ = -torch.rand((b, h, dk), device=card, generator=g)          # decays in (e^-1, 1]
    beta = torch.rand((b, h), device=card, generator=g)
    return r(b, h, dk, dk), q * dk ** -0.5, k, r(b, h, dk), g_, beta


@pytest.mark.card
@pytest.mark.parametrize("b, h, dk", [(256, 32, 128), (8, 4, 16), (3, 5, 128)])
def test_the_kernel_equals_the_torch_recurrence(card, b, h, dk):
    """The state written in place and ``o``, over 3 steps, against
    ``kda_decode_plain`` (float32 sums in another order: 1e-5 of the state's
    and the output's scale)."""
    state, q, k, v, g, beta = _inputs(card, b, h, dk, dk)
    mine = state.clone()
    before = kda_kernels.kda_decode_cuda.launches
    for _ in range(3):
        o = kda_kernels.kda_decode_cuda(mine, q, k, v, g, beta)
        want = kda_kernels.kda_decode_plain(state, q, k, v, g, beta)
        torch.cuda.synchronize()
        torch.testing.assert_close(mine, state, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-5)
    assert kda_kernels.kda_decode_cuda.launches == before + 3


def _model(card):
    cfg = dataclasses.replace(reduced_config(get_config("kimi-linear-48b-a3b")),
                              n_experts_held=4, first_expert_held=2)
    return cfg, init_params(model_decls(cfg, fan_in=True), prng_key(0, card))


def _prompts(cfg, card, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, PROMPT), device=card, generator=g,
                         dtype=torch.int32)


def _generate(cfg, params, prompts):
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


def _no_sync_steps(monkeypatch):
    inner = decode_graph.DecodeGraph.step

    def step(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(decode_graph.DecodeGraph, "step", step)


@pytest.mark.card
def test_graphed_kimi_is_bitwise_the_eager_one_and_reuses_its_graph(card, monkeypatch):
    cfg, params = _model(card)
    assert decode_graph.graphed(cfg, card)
    steps = PROMPT + GEN
    _no_sync_steps(monkeypatch)
    start = dict(decode_graph.COUNTS)
    launches = kda_kernels.kda_decode_cuda.launches
    for call, seed in enumerate((1, 2)):
        prompts = _prompts(cfg, card, seed)
        ROUTING.arm(steps)
        want_tokens, want_logits = _eager(monkeypatch, cfg, params, prompts)
        want = [[(layer, ids.cpu()) for layer, ids in s] for s in ROUTING.take_chosen()]
        ROUTING.arm(steps)
        got_tokens, got_logits = _generate(cfg, params, prompts)
        got = [[(layer, ids.cpu()) for layer, ids in s] for s in ROUTING.take_chosen()]
        assert torch.equal(got_tokens, want_tokens), call
        assert torch.equal(got_logits, want_logits), call
        assert len(got) == len(want) == steps
        for mine, eager in zip(got, want):
            assert [layer for layer, _ in mine] == [layer for layer, _ in eager] == [1, 2, 3]
            assert all(torch.equal(a, b) for (_, a), (_, b) in zip(mine, eager)), call
        assert decode_graph.COUNTS["captures"] - start.get("captures", 0) == 1, call
        assert decode_graph.COUNTS["replays"] - start.get("replays", 0) == (call + 1) * steps
    held = decode_graph._HELD
    assert held is not None and held.route_ends.shape == (3, 4)
    # Each eager step launches the kernel in its 2 KDA layers; the graph
    # launched it twice more (the eager step before the capture, and the
    # capture's recording), then only by replays.
    assert kda_kernels.kda_decode_cuda.launches - launches == 2 * 2 * steps + 2 * 2


@pytest.mark.card
def test_a_reused_graph_starts_from_zeroed_states(card, monkeypatch):
    """After a call, the holder's KDA states are not zero; the next call of
    the same key zeroes them (and the latent cache) before its first
    replay, so its logits equal a fresh eager call's."""
    cfg, params = _model(card)
    _generate(cfg, params, _prompts(cfg, card, 3))
    held = decode_graph._HELD
    assert float(held.cache[0]["S"].abs().max()) > 0
    assert float(held.cache[0]["conv"].abs().max()) > 0
    prompts = _prompts(cfg, card, 4)
    got_tokens, got_logits = _generate(cfg, params, prompts)
    assert decode_graph._HELD is held
    want_tokens, want_logits = _eager(monkeypatch, cfg, params, prompts)
    assert torch.equal(got_logits, want_logits) and torch.equal(got_tokens, want_tokens)
