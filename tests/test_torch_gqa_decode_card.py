"""The decode step's GQA attention kernel (``csrc/gqa_decode.cu``) on the
card, against its plain twin ``gqa_decode_plain`` (``attention._sdpa``'s
arithmetic): positions 0, 1, 15, 127 and 255 of a 256-slot cache, rings
that have wrapped with and without a window shorter than the cache, 1, 4,
7 and 8 query heads a kv head, heads of 64, 80, 128 and 256 values, bf16,
fp16 and float32, the position as an int and as a 0-d tensor, and caches
whose scores do not fit in shared memory (a scratch buffer); over a ring
held in 2 and 4 blocks, the split wrapper against ``_split_softmax``; a
step captured in a CUDA graph and replayed at three positions equals the
eager kernel bit for bit; and ``decode_attention`` takes the kernel for a
whole cache and for one split by seq on the card, and refuses float64.
They need a CUDA device and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_gqa_decode_card.py
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.prng import prng_key
from repro_torch.kernels import gqa_decode
from repro_torch.models import attention as tattn
from repro_torch.models.base import init_params
from repro_torch.sharding.blocks import ModelBlocks

#: Within the values' rounding: a softmax weight rounded one ulp apart
#: where the float32 scores differ in their last place, and the output's
#: one rounding.
TOLERANCES = {torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2),
              torch.float16: dict(rtol=2e-3, atol=1e-3),
              torch.float32: dict(rtol=1e-5, atol=1e-5)}
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _qkv(card, dtype, b, kv, g, s, hd, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randn(shape, device=card, generator=gen).to(dtype)
                 for shape in ((b, kv, g, hd), (b, kv, s, hd), (b, kv, s, hd)))


def _held(card, q, k, v, positions, window=None):
    """The kernel against the twin at each position, as an int and as a
    0-d tensor; the kernel's launches counted."""
    before = gqa_decode.gqa_decode_cuda.launches
    for pos in positions:
        want = gqa_decode.gqa_decode_plain(q, k, v, pos, window)
        for at in (pos, torch.tensor(pos, device=card)):
            got = gqa_decode.gqa_decode_cuda(q, k, v, at, window)
            torch.cuda.synchronize()
            assert got.dtype == v.dtype and got.shape == q.shape
            torch.testing.assert_close(got, want, **TOLERANCES[v.dtype],
                                       msg=lambda m: f"pos {pos}, window {window}: {m}")
    assert gqa_decode.gqa_decode_cuda.launches == before + 2 * len(positions)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 7, 8])
def test_the_kernel_equals_the_twin_over_a_256_slot_cache(card, dtype, hd, g):
    q, k, v = _qkv(card, dtype, 3, 2, g, 256, hd, seed=hd + g)
    _held(card, q, k, v, [0, 1, 15, 127, 255])


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s, window, positions", [
    (64, None, [64, 100, 200]),              # a full ring, wrapped
    (64, 40, [39, 40, 64, 101, 200]),        # a window shorter than the ring
    (16, 6, [5, 6, 17, 40]),
])
def test_the_kernel_equals_the_twin_on_wrapped_rings(card, dtype, s, window, positions):
    q, k, v = _qkv(card, dtype, 4, 3, 4, s, 80)
    _held(card, q, k, v, positions, window)


@pytest.mark.card
@pytest.mark.parametrize("dtype, g, s, hd, window", [
    (torch.bfloat16, 8, 4096, 128, None), (torch.bfloat16, 10, 2048, 256, 2048),
    (torch.bfloat16, 4, 3000, 80, 2500), (torch.float32, 4, 3000, 80, 2500)])
def test_scores_past_shared_memory_go_through_the_scratch_buffer(card, dtype, g, s, hd, window):
    assert gqa_decode.scratch_floats(g, hd, min(s, window or s)) == g * min(s, window or s)
    assert gqa_decode.scratch_floats(4, 80, 256) == 0          # danube's: in shared memory
    q, k, v = _qkv(card, dtype, 2, 2, g, s, hd)
    _held(card, q, k, v, [0, 17, s - 1, s + 500], window)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks, s, window, positions", [
    (2, 64, None, [0, 5, 31, 32, 63, 100]),   # empty blocks, a full ring, wrapped
    (2, 64, 40, [39, 64, 101, 200]),          # a window shorter than the ring
    (4, 256, None, [0, 15, 127, 255, 300]),
    (4, 4096, 2500, [17, 3000, 9000]),        # scores in a scratch buffer
])
def test_the_split_wrapper_equals_split_softmax(card, dtype, blocks, s, window, positions):
    """A ring held in blocks along ``model``: a stats and a part launch a
    block, and their combine, against ``_split_softmax`` on the same
    blocks, the position an int and a 0-d tensor."""
    q, k, v = _qkv(card, dtype, 3, 2, 4, s, 80)
    ck = ModelBlocks(list(k.chunk(blocks, 2)), blocks)
    cv = ModelBlocks(list(v.chunk(blocks, 2)), blocks)
    held = tattn._holders(ck)
    firsts = [first for _, first in held]
    for pos in positions:
        want = tattn._split_softmax(q[:, :, :, None], ck.blocks, cv.blocks,
                                    tattn._slot_biases(ck, held, pos, s, window))[:, :, :, 0]
        for at in (pos, torch.tensor(pos, device=card)):
            before = gqa_decode.gqa_decode_cuda.launches
            got = gqa_decode.gqa_decode_split_cuda(q, ck.blocks, cv.blocks, firsts, s, at, window)
            torch.cuda.synchronize()
            assert gqa_decode.gqa_decode_cuda.launches == before + 2 * blocks
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(got, want, **TOLERANCES[dtype],
                                       msg=lambda m: f"pos {pos}, window {window}: {m}")


@pytest.mark.card
def test_the_danube_shape_at_256_sequences(card):
    """h2o-danube-1.8b's decode: 256 sequences x 8 kv heads x 4 query heads
    a kv head, heads of 80, a 256-slot cache."""
    q, k, v = _qkv(card, torch.bfloat16, 256, 8, 4, 256, 80)
    _held(card, q, k, v, [15, 127, 255], 4096)


@pytest.mark.card
def test_a_captured_step_replays_bitwise_the_eager_kernel(card):
    """The kernel captured in a CUDA graph with the position a 0-d tensor,
    replayed at three positions, equals the eager kernel at each bit for
    bit (the cache written at the position first, as the step does)."""
    q, k, v = _qkv(card, torch.bfloat16, 8, 2, 4, 32, 80)
    new = torch.randn((8, 2, 1, 80), device=card).to(torch.bfloat16)
    pos = torch.zeros((), dtype=torch.int64, device=card)

    def step():
        k.index_copy_(2, (pos % 32).reshape(1), new)
        return gqa_decode.gqa_decode_cuda(q, k, v, pos, 24)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    launches = gqa_decode.gqa_decode_cuda.launches
    for at in (3, 31, 70):
        pos.fill_(at)
        graph.replay()
        replayed = out.clone()
        eager = gqa_decode.gqa_decode_cuda(q, k, v, at, 24)
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager), at
    assert gqa_decode.gqa_decode_cuda.launches == launches + 3      # the eager calls alone


def _danube(card, dtype):
    cfg = dataclasses.replace(reduced_config(get_config("h2o-danube-1.8b")), n_kv_heads=2,
                              dtype=dtype)
    return cfg, init_params(tattn.attention_decls(cfg), prng_key(0, card))


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout, per_step", [("whole", 1), ("seq", 4)])
def test_decode_attention_takes_the_kernel_on_the_card(card, monkeypatch, dtype, layout,
                                                       per_step):
    """Reduced h2o-danube (two query heads a kv head) over a wrapped ring
    of 16, held whole or split by seq over two positions: each step
    launches the kernel once (whole) or twice a block (split) and is within
    the values' rounding of the plain path's step on the same cache."""
    cfg, p = _danube(card, dtype)
    gen = torch.Generator(device=card).manual_seed(1)

    def steps(route):
        ck, cv = tattn.init_kv_cache(4, cfg, 40, 1, card)[0].values()
        if layout == "seq":
            ck, cv = (ModelBlocks(list(c.chunk(2, 2)), 2) for c in (ck, cv))
        outs = []
        with monkeypatch.context() as m:
            m.setattr(gqa_decode, "on_card", route)
            for pos in range(40):
                x = torch.randn((4, 1, cfg.d_model), device=card, generator=gen).to(dtype)
                outs.append(tattn.decode_attention(p, x, ck, cv, pos, cfg,
                                                   window=cfg.sliding_window)[0])
        return torch.stack(outs)

    gen.manual_seed(1)
    before = gqa_decode.gqa_decode_cuda.launches
    mine = steps(lambda t: t.is_cuda)
    assert gqa_decode.gqa_decode_cuda.launches == before + 40 * per_step
    gen.manual_seed(1)
    plain = steps(lambda t: False)
    assert gqa_decode.gqa_decode_cuda.launches == before + 40 * per_step
    torch.testing.assert_close(mine, plain, **TOLERANCES[dtype])


@pytest.mark.card
def test_decode_attention_refuses_a_float64_cache_on_the_card(card):
    """The kernel takes no float64, and a cache on the card never runs the
    plain path."""
    cfg, p = _danube(card, torch.float64)
    ck, cv = tattn.init_kv_cache(4, cfg, 40, 1, card)[0].values()
    x = torch.randn((4, 1, cfg.d_model), device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="bf16, fp16 or float32"):
        tattn.decode_attention(p, x, ck, cv, 3, cfg, window=cfg.sliding_window)
