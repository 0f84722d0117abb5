"""The decode step's CUDA graph on the card, on the reduced h2o-danube
(bf16, a ring of 16 wrapped over 24 positions): graphed ``generate``
equals eager ``generate`` token for token with bitwise logits at every
step, read by wrapping ``launch.serve.decode`` as the benchmark does; a
second call reuses the graph and still equals a fresh eager call; another
batch captures anew; the reduced Moonlight runs eagerly; the position as
a tensor issues as many kernels as the int, and the profiler sees a
replay's kernels.  They need a CUDA device and skip without one.  On the
card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_decode_graph_card.py
"""

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.prng import prng_key
from repro_torch.launch import serve
from repro_torch.launch.specs import model_decls
from repro_torch.models import transformer as tfm
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
    return {k: decode_graph.COUNTS[k] for k in ("captures", "replays", "eager")}


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


@pytest.mark.card
def test_moonlight_runs_eagerly(card):
    cfg, params = _model("moonlight-16b-a3b", card)
    assert not decode_graph.graphed(cfg, card)
    start = _counts()
    tokens, _ = _generate(cfg, params, _prompts(cfg, card, 4))
    assert tokens.shape == (B, GEN)
    now = _counts()
    assert now["replays"] == start["replays"] and now["captures"] == start["captures"]
    assert now["eager"] - start["eager"] == PROMPT + GEN


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
def test_the_tensor_position_issues_the_int_positions_kernels_and_a_replay_shows_them(card):
    cfg, params = _model("h2o-danube-1.8b", card)
    cache = tfm.init_decode_cache(B, cfg, MAX_SEQ, card)
    tok = _prompts(cfg, card, 5)[:, :1]
    pos = torch.full((), 20, dtype=torch.int64, device=card)
    tfm.decode_step(params, tok, cache, 19, cfg)                     # lazy set-up
    tfm.decode_step(params, tok, cache, pos, cfg)
    by_int = _device_ops(lambda: tfm.decode_step(params, tok, cache, 20, cfg))
    by_tensor = _device_ops(lambda: tfm.decode_step(params, tok, cache, pos, cfg))
    assert by_int == by_tensor > 0
    held = decode_graph.holder(params, cfg, B, MAX_SEQ, card)
    held.step(tok, 0)                                                # the capture
    # The token copy, the position fill and the logits' copy beside the step.
    assert _device_ops(lambda: held.step(tok, 1)) == by_tensor + 3
