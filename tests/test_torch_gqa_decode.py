"""The decode step's GQA attention kernel (``csrc/gqa_decode.cu``), on the
CPU: its plain twin ``gqa_decode_plain`` is ``attention._sdpa`` with
``decode_attention``'s mask bit for bit; the wrappers refuse a dtype, a
head or a shape the kernel does not take; the split wrapper's combine of
its blocks is ``_split_softmax``'s; and ``decode_attention`` chooses by
the cache's device alone: the kernel for a cache on the card, the plain
``_split_softmax`` for one on the host.  The kernel's launches are
emulated here in torch operations; the kernel itself needs a card
(``test_torch_gqa_decode_card.py``).
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
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

# (position, cache slots, window): empty slots, a full ring, wrapped rings
# with and without a window shorter than the ring.
RINGS = [(0, 16, None), (5, 16, None), (15, 16, 16), (37, 16, None), (37, 16, 7), (100, 32, 40)]


def _qkv(dtype, s, b=2, kv=3, g=4, hd=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((b, kv, g, 1, hd), (b, kv, s, hd), (b, kv, s, hd)))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
@pytest.mark.parametrize("pos, s, window", RINGS)
def test_the_plain_twin_is_sdpa_with_decode_attentions_mask_bit_for_bit(dtype, pos, s, window):
    q, k, v = _qkv(dtype, s)
    cache = ModelBlocks([k])
    bias = tattn._slot_biases(cache, tattn._holders(cache), pos, s, window)[0]
    want = tattn._sdpa(q, k, v, bias)[:, :, :, 0]
    for at in (pos, torch.tensor(pos)):
        got = gqa_decode.gqa_decode_plain(q[:, :, :, 0], k, v, at, window)
        assert got.dtype == dtype and torch.equal(got, want)


def test_visible_is_decode_attentions_mask():
    """A slot is visible where the last position written to it (slot
    ``a % s`` for each ``a`` up to ``pos``) lies within the window of
    ``pos``; the decode mask is its bias."""
    for s in (1, 6, 16):
        for window in (None, 1, 4, 16, 30):
            for pos in range(0, 3 * s + 2):
                last = {a % s: a for a in range(pos + 1)}
                want = torch.tensor([i in last and (window is None or pos - last[i] < window)
                                     for i in range(s)])
                cache = ModelBlocks([torch.zeros((1, 1, s, 8))])
                bias = tattn._slot_biases(cache, tattn._holders(cache), pos, s, window)[0][0]
                assert torch.equal(bias == 0, want)
                for at in (pos, torch.tensor(pos)):
                    assert torch.equal(gqa_decode.visible(at, torch.arange(s), s, window), want)
                assert int(want.sum()) == min(pos + 1, s, window or s)


# What the wrappers refuse, on the host as on the card: (what, q's dtype,
# the caches' dtype, head, the caches' slots against q's batch, window).
REFUSED = [
    ("float64", torch.float64, torch.float64, 16, 2, None, "bf16, fp16 or float32"),
    ("q and cache dtypes differ", torch.float32, torch.bfloat16, 16, 2, None, "alike"),
    ("a head of 12", torch.bfloat16, torch.bfloat16, 12, 2, None, "a head of 8 to 256"),
    ("a head of 264", torch.bfloat16, torch.bfloat16, 264, 2, None, "a head of 8 to 256"),
    ("a window of 0", torch.bfloat16, torch.bfloat16, 16, 2, 0, "window"),
    ("another batch", torch.bfloat16, torch.bfloat16, 16, 3, None, "against caches"),
]


@pytest.mark.parametrize("case, qdtype, dtype, hd, b, window, match", REFUSED)
def test_the_wrappers_refuse_what_the_kernel_does_not_take(case, qdtype, dtype, hd, b, window,
                                                           match):
    q = torch.zeros((2, 3, 4, hd), dtype=qdtype)
    k = torch.zeros((b, 3, 16, hd), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        gqa_decode.gqa_decode_cuda(q, k, k, 3, window)
    with pytest.raises(ValueError, match=match):
        gqa_decode.gqa_decode_split_cuda(q, [k, k], [k, k], [0, 16], 32, 3, window)


def test_the_wrapper_refuses_cpu_tensors():
    q, k, v = _qkv(torch.bfloat16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        gqa_decode.gqa_decode_cuda(q[:, :, :, 0], k, v, 3)


def test_a_cache_is_read_contiguous_from_a_16_byte_boundary():
    k = torch.randn((2, 3, 16, 24)).to(torch.bfloat16)
    assert gqa_decode._aligned(k) is k
    view = k.transpose(2, 3)
    flat = torch.zeros(k.numel() + 1, dtype=torch.bfloat16)
    off = flat[1:].view(k.shape).copy_(k)            # contiguous, 2 bytes past a boundary
    for t in (view, off):
        got = gqa_decode._aligned(t)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, t)


def _emulated(mode, q, k, v, out, stats, pos, s_cache, first, window):
    """One launch of ``csrc/gqa_decode.cu`` in torch operations on the
    host: the whole cache's output, a block's maxima and sums, or its
    float32 part given the ring's maxima and totals."""
    scores = torch.einsum("bkgh,bksh->bkgs", q.float(), k.float()) * q.shape[-1] ** -0.5
    slots = torch.arange(first, first + k.shape[2])
    scores = scores.masked_fill(~gqa_decode.visible(pos, slots, s_cache, window),
                                float("-inf"))
    if mode == gqa_decode.WHOLE:
        out.copy_(gqa_decode.gqa_decode_plain(q, k, v, pos, window))
    elif mode == gqa_decode.STATS:
        top = scores.amax(-1)
        sums = torch.exp(scores - top[..., None]).sum(-1)
        stats.copy_(torch.stack([top, torch.where(top.isinf(), 0.0, sums)], -1))
    else:
        w = (torch.exp(scores - stats[..., :1]) / stats[..., 1:]).to(v.dtype)
        out.copy_(torch.einsum("bkgs,bksh->bkgh", w.float(), v.float()))
    gqa_decode.gqa_decode_cuda.launches += 1


#: Within the values' rounding: a weight rounded one ulp apart where the
#: combined totals differ in their last place.
CLOSE = {torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2), torch.float16: dict(rtol=2e-3, atol=1e-3),
         torch.float32: dict(rtol=1e-5, atol=1e-6)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos, s, window", RINGS)
def test_the_split_wrapper_combines_its_blocks_as_split_softmax(monkeypatch, dtype, pos, s,
                                                                window):
    """Over a ring held in two blocks, the stats launches' combine and the
    part launches' sum (each launch emulated on the host) are
    ``_split_softmax`` within the values' rounding: two launches a
    block."""
    q, k, v = _qkv(dtype, s)
    ck, cv = ModelBlocks(list(k.chunk(2, 2)), 2), ModelBlocks(list(v.chunk(2, 2)), 2)
    held = tattn._holders(ck)
    want = tattn._split_softmax(q, ck.blocks, cv.blocks,
                                tattn._slot_biases(ck, held, pos, s, window))[:, :, :, 0]
    monkeypatch.setattr(gqa_decode, "_launch", _emulated)
    before = gqa_decode.gqa_decode_cuda.launches
    got = gqa_decode.gqa_decode_split_cuda(q[:, :, :, 0], ck.blocks, cv.blocks,
                                           [first for _, first in held], s, pos, window)
    assert gqa_decode.gqa_decode_cuda.launches == before + 4
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, **CLOSE[dtype])


def _attention(dtype, head_dim=16):
    cfg = dataclasses.replace(reduced_config(get_config("h2o-danube-1.8b")), n_kv_heads=2,
                              head_dim=head_dim, dtype=dtype)
    return cfg, init_params(tattn.attention_decls(cfg), prng_key(0))


def _cache(cfg, layout):
    """A 16-slot ring (the window) held whole, split by ``seq`` over two
    positions, or whole on each of two positions."""
    k, v = tattn.init_kv_cache(2, cfg, 24, 1)[0].values()
    if layout == "whole":
        return k, v
    if layout == "seq":
        return ModelBlocks(list(k.chunk(2, 2)), 2), ModelBlocks(list(v.chunk(2, 2)), 2)
    return ModelBlocks([k, k.clone()]), ModelBlocks([v, v.clone()])


def _steps(cfg, p, layout, tensor_pos, n=20):
    """``n`` decode steps over the ring (it wraps): each step's output."""
    ck, cv = _cache(cfg, layout)
    gen = torch.Generator().manual_seed(3)
    outs = []
    for pos in range(n):
        x = torch.randn((2, 1, cfg.d_model), generator=gen).to(cfg.dtype)
        at = torch.tensor(pos) if tensor_pos else pos
        out, ck, cv = tattn.decode_attention(p, x, ck, cv, at, cfg, window=cfg.sliding_window)
        outs.append(out)
    return torch.stack(outs)


# (case, dtype, head, layout, on the card, what it takes): the whole
# kernel, the split one, the plain path, or a refusal.
ROUTES = [
    ("bf16 whole cache on the card", torch.bfloat16, 16, "whole", True, "whole"),
    ("fp16 whole cache on the card", torch.float16, 16, "whole", True, "whole"),
    ("float32 whole cache on the card", torch.float32, 16, "whole", True, "whole"),
    ("whole on two model positions", torch.bfloat16, 16, "copies", True, "whole"),
    ("bf16 blocks over model by seq", torch.bfloat16, 16, "seq", True, "split"),
    ("float32 blocks over model by seq", torch.float32, 16, "seq", True, "split"),
    ("the CPU", torch.bfloat16, 16, "whole", False, "plain"),
    ("float64 on the CPU", torch.float64, 16, "whole", False, "plain"),
    ("float64 on the card", torch.float64, 16, "whole", True, "refused"),
    ("a head of 12 on the card", torch.bfloat16, 12, "whole", True, "refused"),
    ("a head of 264 on the card", torch.bfloat16, 264, "whole", True, "refused"),
]


# A cache split by seq takes the position as an int only.
@pytest.mark.parametrize("case, dtype, head_dim, layout, card, taken, tensor_pos", [
    (*route, tensor_pos) for route in ROUTES for tensor_pos in (False, True)
    if not (tensor_pos and route[3] == "seq")])
def test_decode_attention_takes_the_kernel_only_where_it_fits(
        monkeypatch, case, dtype, head_dim, layout, card, taken, tensor_pos):
    """A cache on the card goes to the kernel (its launches emulated on the
    host, the tensors standing in for the card's): a whole cache in one
    launch a step, equal to the plain path's step bit for bit, a cache
    split by seq in two launches a block and step, within the values'
    rounding; a dtype or head the kernel does not take raises.  A cache on
    the host runs the plain path."""
    cfg, p = _attention(dtype, head_dim)
    if taken == "refused":
        monkeypatch.setattr(gqa_decode, "on_card", lambda t: True)
        with pytest.raises(ValueError, match="gqa_decode"):
            _steps(cfg, p, layout, tensor_pos)
        return
    want = _steps(cfg, p, layout, tensor_pos)
    monkeypatch.setattr(gqa_decode, "_launch", _emulated)
    if card:
        monkeypatch.setattr(gqa_decode, "on_card", lambda t: True)
    before = gqa_decode.gqa_decode_cuda.launches
    got = _steps(cfg, p, layout, tensor_pos)
    launches = gqa_decode.gqa_decode_cuda.launches - before
    assert launches == {"whole": 20, "split": 80, "plain": 0}[taken], case
    if taken == "split":
        torch.testing.assert_close(got, want, **CLOSE[dtype])
    else:
        assert torch.equal(got, want), case
