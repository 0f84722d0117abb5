"""The decode step as a CUDA graph, on the CPU: the position as a 0-d
tensor gives bitwise the int position's logits and cache, step by step,
on the reduced h2o-danube (its whole cache, and a ring of 16 wrapped over
40 positions) and on the reduced Moonlight (its latent cache and its
routing record too); the rule that decides which ``generate`` calls are
graphed, on each kind of config; a graphed step's routing handed to
``ROUTING`` as the eager step records it, through ``DecodeGraph.step``
with CPU stand-ins for the stream and the graph; the holder's reuse and
refusal.  The capture and the replay need a card
(``test_torch_decode_graph_card.py``).
"""

import contextlib
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.prng import prng_key
from repro_torch.launch import serve
from repro_torch.launch.specs import model_decls
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params
from repro_torch.models.moe import ROUTING
from repro_torch.train import decode_graph, serve_step
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

DANUBE, MOONLIGHT = "h2o-danube-1.8b", "moonlight-16b-a3b"


def _model(arch):
    cfg = reduced_config(get_config(arch))
    return cfg, init_params(model_decls(cfg, fan_in=True), prng_key(0))


def _danube():
    return _model(DANUBE)


def _tokens(cfg, steps, b=3):
    return torch.randint(0, cfg.vocab_size, (b, steps),
                         generator=torch.Generator().manual_seed(1), dtype=torch.int32)


@pytest.mark.parametrize("arch,max_seq,steps", [(DANUBE, 12, 12), (DANUBE, 40, 40),
                                                (MOONLIGHT, 12, 12)],
                         ids=["whole", "ring_wraps", "moonlight-whole"])
def test_tensor_position_is_bitwise_the_int_position(arch, max_seq, steps):
    cfg, params = _model(arch)
    ints = tfm.init_decode_cache(3, cfg, max_seq, "cpu")
    tens = tfm.init_decode_cache(3, cfg, max_seq, "cpu")
    if arch == DANUBE:
        assert cfg.sliding_window == 16
        assert ints[0]["k"].shape[2] == min(max_seq, 16)
    toks = _tokens(cfg, steps)
    pos = torch.zeros((), dtype=torch.int64)
    ROUTING.arm(2 * steps)
    for i in range(steps):
        want, ints = tfm.decode_step(params, toks[:, i:i + 1], ints, i, cfg)
        pos.fill_(i)
        got, tens = tfm.decode_step(params, toks[:, i:i + 1], tens, pos, cfg)
        assert torch.equal(got, want), i
        for a, b in zip(tens, ints):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), i
    chosen = ROUTING.take_chosen()
    if arch == MOONLIGHT:
        assert sorted(ints[0]) == ["c", "k_r"] and len(chosen) == 2 * steps
        for by_int, by_tensor in zip(chosen[::2], chosen[1::2]):
            assert [layer for layer, _ in by_int] == [layer for layer, _ in by_tensor] == [1, 2]
            assert all(torch.equal(a, b) for (_, a), (_, b) in zip(by_int, by_tensor))
    else:
        assert chosen == []


_RULE = [
    ("h2o-danube-1.8b", "cuda", {}, True),
    ("mistral-nemo-12b", "cuda", {}, True),
    ("h2o-danube-1.8b", "cpu", {}, False),
    ("h2o-danube-1.8b", "cuda", {"mesh": object()}, False),
    ("h2o-danube-1.8b", "cuda", {"frontend_embeds": torch.zeros(1)}, False),
    ("seamless-m4t-large-v2", "cuda", {}, False),
    ("qwen2-moe-a2.7b", "cuda", {}, False),
    ("moonlight-16b-a3b", "cuda", {}, True),
    ("moonlight-16b-a3b", "cpu", {}, False),
    ("moonlight-16b-a3b", "cuda", {"mesh": object()}, False),
    ("recurrentgemma-2b", "cuda", {}, False),
    ("xlstm-350m", "cuda", {}, False),
    ("qwen2-vl-7b", "cuda", {}, False),
]


@pytest.mark.parametrize("arch,device,kw,want", _RULE,
                         ids=[f"{a}-{d}-{'+'.join(k) or 'plain'}" for a, d, k, _ in _RULE])
def test_which_steps_are_graphed(arch, device, kw, want):
    """Decided from the input alone: decoders of 'attn' or 'mla' layers,
    dense or with the sigmoid router's dropless experts, on a CUDA device
    without a mesh, M-RoPE or front-end embeddings."""
    assert decode_graph.graphed(get_config(arch), torch.device(device), **kw) is want


class _Graph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``: under the stand-in
    ``torch.cuda.graph`` the step runs eagerly; a replay runs the held
    step again into the logits the capture left."""

    held = None

    def replay(self):
        _Graph.held.logits.copy_(_Graph.held._body())


class _Stream:
    def wait_stream(self, other):
        pass


def _graph_on_the_cpu(monkeypatch):
    for name, value in (("device", lambda d: contextlib.nullcontext()), ("Stream", _Stream),
                        ("current_stream", _Stream), ("stream", lambda s: contextlib.nullcontext()),
                        ("CUDAGraph", _Graph), ("graph", lambda g: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)


def test_a_replayed_step_hands_routing_the_eager_steps_records(monkeypatch):
    """The copy-out, on the slots a step wrote, gives ``ROUTING`` the
    eager steps' records: the same steps, layers and ids in order, and the
    same group ends under a profiler.  The step that captures records once:
    neither its eager step nor the capture records."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params = _model(MOONLIGHT)
    steps, counted = 6, 2
    toks = _tokens(cfg, steps)

    def run(step):
        ROUTING.arm(steps)
        ROUTING.arm_counts()
        logits = [step(toks[:, i:i + 1], i) for i in range(steps - counted)]
        with profile(activities=[ProfilerActivity.CPU]):
            logits += [step(toks[:, i:i + 1], i) for i in range(steps - counted, steps)]
        return logits, ROUTING.take_chosen(), ROUTING.take_counts()

    cache = tfm.init_decode_cache(3, cfg, steps, "cpu")
    want = run(lambda t, i: tfm.decode_step(params, t, cache, i, cfg)[0])
    _graph_on_the_cpu(monkeypatch)
    held = _Graph.held = decode_graph.DecodeGraph(params, cfg, 3, steps, "cpu")
    assert held.dropless == [1, 2] and held.route_ids.shape == (2, 3, cfg.n_experts_per_token)
    before = dict(decode_graph.COUNTS)
    got = run(held.step)
    assert decode_graph.COUNTS["captures"] - before.get("captures", 0) == 1
    assert decode_graph.COUNTS["replays"] - before.get("replays", 0) == steps
    assert decode_graph.COUNTS["routing_copies"] - before.get("routing_copies", 0) == steps
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert len(got[1]) == len(want[1]) == steps
    for mine, eager in zip(got[1], want[1]):
        assert [layer for layer, _ in mine] == [layer for layer, _ in eager] == [1, 2]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(mine, eager))
    assert len(got[2]) == len(want[2]) == counted * 2
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    for a, b in zip(held.cache, cache):
        assert all(torch.equal(a[k], b[k]) for k in a)
    quiet = dict(decode_graph.COUNTS)
    held.step(toks[:, :1], 0)                       # unarmed: nothing kept, nothing copied
    assert decode_graph.COUNTS["routing_copies"] == quiet["routing_copies"]
    assert ROUTING.take_chosen() == [] and ROUTING.take_counts() == []


def test_generate_on_the_cpu_runs_every_step_eagerly():
    cfg, params = _danube()
    decode_graph.drop()
    before = dict(decode_graph.COUNTS)
    prompts = torch.randint(0, cfg.vocab_size, (2, 4), dtype=torch.int32)
    serve.generate(cfg, params, prompts, 3)
    assert decode_graph.COUNTS["eager"] - before.get("eager", 0) == 7
    assert decode_graph.COUNTS["replays"] == before.get("replays", 0)
    assert decode_graph._HELD is None


def test_the_holder_is_reused_zeroed_and_replaced_by_another_key():
    cfg, params = _danube()
    first = decode_graph.holder(params, cfg, 2, 8, "cpu")
    first.cache[0]["k"].fill_(1.0)
    again = decode_graph.holder(params, cfg, 2, 8, torch.device("cpu"))
    assert again is first
    assert all(float(leaf.abs().max()) == 0.0 for layer in again.cache for leaf in layer.values())
    other = decode_graph.holder(params, cfg, 3, 8, "cpu")
    assert other is not first and other.cache[0]["k"].shape[0] == 3
    assert decode_graph.holder(params, dataclasses.replace(cfg), 3, 8, "cpu") is other
    _, params2 = _danube()
    assert decode_graph.holder(params2, cfg, 3, 8, "cpu") is not other
    decode_graph.drop()
    assert decode_graph._HELD is None


def test_decode_refuses_a_holder_of_other_parameters():
    cfg, params = _danube()
    held = decode_graph.DecodeGraph(params, cfg, 2, 8, "cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    _, other = _danube()
    with pytest.raises(ValueError, match="other parameters"):
        serve_step.decode(other, tok, held, 0, cfg)
    with pytest.raises(ValueError, match="other parameters"):
        serve_step.decode(params, tok, held, 0, dataclasses.replace(cfg, norm_eps=1e-3))
