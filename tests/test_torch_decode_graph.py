"""The decode step as a CUDA graph, on the CPU: the position as a 0-d
tensor gives bitwise the int position's logits and cache, step by step,
on the reduced h2o-danube (its whole cache, and a ring of 16 wrapped over
40 positions); the rule that decides which ``generate`` calls are graphed,
on each kind of config; the holder's reuse and refusal.  The capture and
the replay need a card (``test_torch_decode_graph_card.py``).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.prng import prng_key
from repro_torch.launch import serve
from repro_torch.launch.specs import model_decls
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params
from repro_torch.train import decode_graph, serve_step
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")


def _danube():
    cfg = reduced_config(get_config("h2o-danube-1.8b"))
    return cfg, init_params(model_decls(cfg, fan_in=True), prng_key(0))


@pytest.mark.parametrize("max_seq,steps", [(12, 12), (40, 40)], ids=["whole", "ring_wraps"])
def test_tensor_position_is_bitwise_the_int_position(max_seq, steps):
    cfg, params = _danube()
    assert cfg.sliding_window == 16
    ints = tfm.init_decode_cache(3, cfg, max_seq, "cpu")
    tens = tfm.init_decode_cache(3, cfg, max_seq, "cpu")
    assert ints[0]["k"].shape[2] == min(max_seq, 16)
    toks = torch.randint(0, cfg.vocab_size, (3, steps), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    pos = torch.zeros((), dtype=torch.int64)
    for i in range(steps):
        want, ints = tfm.decode_step(params, toks[:, i:i + 1], ints, i, cfg)
        pos.fill_(i)
        got, tens = tfm.decode_step(params, toks[:, i:i + 1], tens, pos, cfg)
        assert torch.equal(got, want), i
        for a, b in zip(tens, ints):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]), i


_RULE = [
    ("h2o-danube-1.8b", "cuda", {}, True),
    ("mistral-nemo-12b", "cuda", {}, True),
    ("h2o-danube-1.8b", "cpu", {}, False),
    ("h2o-danube-1.8b", "cuda", {"mesh": object()}, False),
    ("h2o-danube-1.8b", "cuda", {"frontend_embeds": torch.zeros(1)}, False),
    ("seamless-m4t-large-v2", "cuda", {}, False),
    ("qwen2-moe-a2.7b", "cuda", {}, False),
    ("moonlight-16b-a3b", "cuda", {}, False),
    ("recurrentgemma-2b", "cuda", {}, False),
    ("xlstm-350m", "cuda", {}, False),
    ("qwen2-vl-7b", "cuda", {}, False),
]


@pytest.mark.parametrize("arch,device,kw,want", _RULE,
                         ids=[f"{a}-{d}-{'+'.join(k) or 'plain'}" for a, d, k, _ in _RULE])
def test_which_steps_are_graphed(arch, device, kw, want):
    """Decided from the input alone: dense 'attn' decoders on a CUDA
    device without a mesh, M-RoPE or front-end embeddings."""
    assert decode_graph.graphed(get_config(arch), torch.device(device), **kw) is want


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
