"""Attention: the port's copy of ``repro/models/attention.py``.

Full, sliding-window and local attention with GQA, the query axis in
chunks so the [S, S] score matrix never materialises whole, and the
one-token decode against a KV cache (a ring buffer for windowed archs, so
a long decode keeps only the window).

Shapes: activations [B, S, D]; heads [B, S, H, hd]; caches [B, KV, S, hd].
The scores and the softmax are float32 whatever the weights' dtype (the
reference's ``preferred_element_type=float32``); the softmax weights are
cast to the values' dtype before the second product.  Written in plain
PyTorch in the reference's order of operations, not through a library
attention kernel.

One body over the positions of the heads' model group
(``sharding/blocks.py:model_group``; one position holding the leaves
whole when unmeshed): each position computes ``n_heads / M`` query heads
and its kv heads (those of its own block where ``n_kv_heads`` divides
``M``; else it reads ``wk``/``wv`` whole and takes the kv heads its query
heads use), and its rows of ``wo``; the partial outputs are summed over
``model``.  Heads that do not split whole run on one position, the
leaves read whole and recorded.  A decode cache is held in blocks
(:class:`ModelBlocks`; a whole ``[B, KV, S, hd]`` cache is one block):
laid out by ``seq``, the new key and value go to the position holding
slot ``pos % S_cache``, each position scores every head against its own
slots, and the partial softmaxes are combined over ``model`` (maxima,
sums, weighted values) in position order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    row_parallel,
)
from repro_torch.kernels import gqa_decode
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import mrope, rope, wide
from repro_torch.sharding.blocks import ModelBlocks, ModelGroup, model_group, whole_group

__all__ = [
    "attention_decls",
    "attention_apply",
    "cache_len",
    "chunked_attention",
    "cross_decode_attention",
    "cross_kv",
    "decode_attention",
    "init_kv_cache",
]

NEG_INF = -2.0e38


def attention_decls(cfg: ModelConfig, cross: bool = False) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    return {
        "wq": ParamDecl((d, h * hd), ("fsdp", "tensor"), dtype=dt),
        "wk": ParamDecl((d, kv * hd), ("fsdp", "tensor"), dtype=dt),
        "wv": ParamDecl((d, kv * hd), ("fsdp", "tensor"), dtype=dt),
        "wo": ParamDecl((h * hd, d), ("tensor", "fsdp"), dtype=dt),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _mask_bias(
    qpos: torch.Tensor,       # [Sq] absolute query positions
    kpos: torch.Tensor,       # [Sk] absolute key positions
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Additive fp32 bias [Sq, Sk]: 0 where visible, NEG_INF where masked."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= qpos[:, None] - kpos[None, :] < window
    return _bias(ok)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _sdpa(
    q: torch.Tensor,          # [B, KV, G, Sq, hd]
    k: torch.Tensor,          # [B, KV, Sk, hd]
    v: torch.Tensor,          # [B, KV, Sk, hd]
    bias: torch.Tensor,       # [Sq, Sk]
) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bkgqh,bksh->bkgqs", wide(q), wide(k))
    scores = scores * scale + bias[None, None, None]
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bksh->bkgqh", w.to(v.dtype), v)


def chunked_attention(
    q: torch.Tensor,          # [B, H, Sq, hd]
    k: torch.Tensor,          # [B, KV, Sk, hd]
    v: torch.Tensor,          # [B, KV, Sk, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Memory-bounded attention over query chunks; returns [B, H, Sq, v's hd].

    ``q_offset`` is the absolute position of q[0] (prefill continuation).
    GQA grouping is derived from H against KV.  A length that ``chunk``
    does not divide runs as one chunk."""
    b, h, sq, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, hd)
    kpos = torch.arange(k.shape[2], device=q.device)

    chunk = min(chunk, sq)
    if sq % chunk:
        chunk = sq
    outs = []
    for c0 in range(0, sq, chunk):
        qpos = q_offset + c0 + torch.arange(chunk, device=q.device)
        outs.append(_sdpa(qg[:, :, :, c0 : c0 + chunk], k, v,
                          _mask_bias(qpos, kpos, causal, window)))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.reshape(b, h, sq, v.shape[-1])


def _heads_group(p, cfg: ModelConfig) -> ModelGroup:
    """The model group an attention splits over: ``wq``/``wo`` split into
    whole query heads and kv heads that either divide over ``model`` or
    are fewer than its positions and divide them.  Else one position, the
    leaves recorded as read whole."""
    group = model_group(p, "wq", "wo")
    m, h, kv = group.size, cfg.n_heads, cfg.n_kv_heads
    if h % m or (kv % m and m % kv):
        for key in ("wq", "wk", "wv", "wo"):
            p.note_gathered(key, f"{h} query and {kv} kv heads do not split over model {m}")
        return whole_group(p)
    return group


def _kv_blocks(p, group: ModelGroup, cfg: ModelConfig, key: str) -> List[torch.Tensor]:
    """Each position's columns of ``wk`` or ``wv``: its own block where
    ``n_kv_heads`` divides over ``model``; else the leaf read whole (and
    recorded) and the one kv head its query heads use."""
    m, h, kv, hd = group.size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kv % m == 0:
        return group.local(key)
    ws = group.whole(key, f"n_kv_heads {kv} does not divide over model {m}")
    g = h // kv
    return [w[:, (i * (h // m) // g) * hd:(i * (h // m) // g + 1) * hd] for i, w in enumerate(ws)]


def _attend(x, src, wq, wk, wv, cfg: ModelConfig, positions, *, causal, window, use_rope,
            cross, chunk) -> torch.Tensor:
    """Attention of the heads of ``wq`` (their kv heads those of ``wk``,
    ``wv``): [B, S, heads * hd], before the out projection."""
    hd = cfg.head_dim
    h, kv = wq.shape[1] // hd, wk.shape[1] // hd
    q = _split_heads(x @ wq, h, hd)
    k = _split_heads(src @ wk, kv, hd)
    vv = _split_heads(src @ wv, kv, hd)
    if use_rope and not cross:
        if cfg.mrope_sections is not None:
            q = mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    out = chunked_attention(
        q.transpose(1, 2), k.transpose(1, 2), vv.transpose(1, 2),
        causal=causal and not cross,
        window=window,
        chunk=chunk,
    )
    return out.transpose(1, 2).reshape(x.shape[0], x.shape[1], h * hd)


def attention_apply(
    p,
    x: torch.Tensor,                     # [B, S, D]
    cfg: ModelConfig,
    positions: torch.Tensor,             # [B, S] or [3, B, S] for M-RoPE
    *,
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    kv_source: Optional[torch.Tensor] = None,   # cross-attention encoder output
    chunk: int = 512,
) -> torch.Tensor:
    """Train/prefill attention (no cache)."""
    kw = dict(causal=causal, window=window, use_rope=use_rope, cross=kv_source is not None,
              chunk=chunk)
    group = _heads_group(p, cfg)
    devs = group.devices
    xs = copy_to_model(x, devs)
    srcs = xs if kv_source is None else copy_to_model(kv_source, devs)
    outs = [_attend(xm, sm, wq, wk, wv, cfg, positions.to(xm.device), **kw)
            for xm, sm, wq, wk, wv in zip(xs, srcs, group.local("wq"),
                                          _kv_blocks(p, group, cfg, "wk"),
                                          _kv_blocks(p, group, cfg, "wv"))]
    return row_parallel(outs, group.local("wo"), x.device)


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Ring-buffer length: SWA/local archs only ever keep the window."""
    win = cfg.sliding_window or cfg.local_window
    if win is not None:
        return min(win, max_seq)
    return max_seq


def init_kv_cache(batch: int, cfg: ModelConfig, max_seq: int, n_layers: int, device=None
                  ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer caches {k, v}: zeros [B, KV, S_cache, hd] in ``cfg.dtype``
    (the reference stacks them into [L, B, KV, S_cache, hd])."""
    shape = (batch, cfg.n_kv_heads, cache_len(cfg, max_seq), cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(n_layers)]


def _project_heads(p, group: ModelGroup, x: torch.Tensor, cfg: ModelConfig,
                  keys=("wq", "wk", "wv")):
    """``x`` [B, S, D] through each of ``keys`` as heads [B, S, n, hd]
    (``n_heads`` for ``wq``, ``n_kv_heads`` otherwise), joined on ``x``'s
    device: computed by each position's heads and gathered."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    xs = copy_to_model(x, group.devices)
    outs = []
    for k in keys:
        if k != "wq" and kv % group.size:
            outs.append(x @ p.whole(k, f"n_kv_heads {kv} does not divide over model "
                                       f"{group.size}"))
        else:
            outs.append(gather_from_model([xm @ w for xm, w in zip(xs, group.local(k))],
                                          -1, [x.device])[0])
    return tuple(_split_heads(o, cfg.n_heads if k == "wq" else kv, hd)
                 for o, k in zip(outs, keys))


def _out_proj(group: ModelGroup, out: torch.Tensor) -> torch.Tensor:
    """``out`` [B, 1, H * hd] through ``wo``, row-parallel."""
    n = out.shape[-1] // group.size
    outs = [om[..., i * n:(i + 1) * n]
            for i, om in enumerate(copy_to_model(out, group.devices))]
    return row_parallel(outs, group.local("wo"), out.device)


def _split_softmax(qg: torch.Tensor, ks: List[torch.Tensor], vs: List[torch.Tensor],
                   biases: List[torch.Tensor]) -> torch.Tensor:
    """Attention of ``qg`` [B, KV, G, 1, hd] over slots held in blocks (each
    ``ks[i]``/``vs[i]`` [B, KV, S_i, hd] with its additive bias [1, S_i], on
    its own device), on ``qg``'s device in the values' dtype.  One block is
    :func:`_sdpa`.  Over several, the blocks' maxima and sums of
    exponentials are combined in order first; each block's normalised
    weights, cast to the values' dtype as :func:`_sdpa` casts them, weight
    its values in float32, and the partial outputs are summed in order and
    rounded once.  A block whose slots are all masked adds zeros."""
    if len(ks) == 1:
        return _sdpa(qg.to(ks[0].device), ks[0], vs[0], biases[0]).to(qg.device)
    home, scale = qg.device, qg.shape[-1] ** -0.5
    scores = [torch.einsum("bkgqh,bksh->bkgqs", wide(qg.to(k.device)), wide(k)) * scale
              + bias[None, None, None] for k, bias in zip(ks, biases)]
    mx = scores[0].amax(-1, keepdim=True)
    for sc in scores[1:]:
        mx = torch.maximum(mx, sc.amax(-1, keepdim=True).to(home))
    es = [torch.exp(sc - mx.to(sc.device)) for sc in scores]
    total = reduce_from_model([e.sum(-1, keepdim=True) for e in es], home)
    parts = [torch.einsum("bkgqs,bksh->bkgqh", wide((e / total.to(e.device)).to(v.dtype)),
                          wide(v)) for e, v in zip(es, vs)]
    return reduce_from_model(parts, home, dtype=vs[0].dtype)


def _holders(cache: ModelBlocks) -> List[Tuple[int, int]]:
    """(position, first slot) of each block of a cache's slots: every
    position along ``seq`` when split, else the first position's whole
    copy."""
    n = cache.blocks[0].shape[2]
    if cache.dim is None:
        return [(0, 0)]
    return [(i, i * n) for i in range(len(cache.blocks))]


def _rope_decode(q, k, pos, cfg: ModelConfig, positions_3d):
    """``q`` and ``k`` rotated to ``pos``: an int, or (no M-RoPE) a 0-d
    integer tensor on their device, expanded to the batch; the positions
    int32 either way."""
    b, dev = q.shape[0], q.device
    if cfg.mrope_sections is not None:
        p3 = positions_3d
        if p3 is None:
            p3 = torch.full((3, b, 1), pos, dtype=torch.int32, device=dev)
        return (mrope(q, p3, cfg.rope_theta, cfg.mrope_sections),
                mrope(k, p3, cfg.rope_theta, cfg.mrope_sections))
    if isinstance(pos, torch.Tensor):
        posb = pos.to(torch.int32).expand(b, 1)
    else:
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    return rope(q, posb, cfg.rope_theta), rope(k, posb, cfg.rope_theta)


def _slot_biases(cache: ModelBlocks, held, pos, s_cache: int, window: Optional[int]
                 ) -> List[torch.Tensor]:
    """The additive bias [1, S_i] of each held block's slots at ``pos``
    (:func:`repro_torch.kernels.gqa_decode.visible`)."""
    return [_bias(gqa_decode.visible(pos, torch.arange(first, first + cache.blocks[i].shape[2],
                                                       device=cache.blocks[i].device),
                                     s_cache, window))[None, :]
            for i, first in held]


def decode_attention(
    p,
    x: torch.Tensor,                     # [B, 1, D] current token activations
    cache_k,                             # [B, KV, S_cache, hd], or its ModelBlocks
    cache_v,
    pos,                                 # current position: int, or 0-d int64 on x's device
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    positions_3d: Optional[torch.Tensor] = None,  # [3, B, 1] for M-RoPE decode
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step; returns (out [B, 1, D], cache_k, cache_v).

    The new key and value are written into the caches in place, at slot
    ``pos % S_cache`` (a ring for windowed caches, ``pos`` itself for full
    ones).  Masking rebuilds each slot's absolute position from the write
    position, so both layouts share one code path.  A cache held in blocks
    along ``model`` (:class:`ModelBlocks`) is attended split; a whole cache
    is its one block.  A cache on the card goes through the kernel of
    :mod:`repro_torch.kernels.gqa_decode`, which reads only the visible
    slots (a whole cache in one launch, blocks through
    ``gqa_decode_split_cuda``) and raises on a dtype or head it does not
    take; a cache on the host through :func:`_split_softmax`.

    ``pos`` as a 0-d int64 tensor (a whole cache, no M-RoPE) is never read
    back to the host, so the step can be captured in a CUDA graph and
    replayed at any position: the slot is written by ``index_copy_`` and
    each slot's absolute position is ``pos - (pos - slot) mod S_cache``,
    for an int as for a tensor."""
    b, h, kv, hd = x.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = (c if isinstance(c, ModelBlocks) else ModelBlocks([c]) for c in (cache_k, cache_v))
    group = _heads_group(p, cfg)
    q, k, v = _project_heads(p, group, x, cfg)
    q, k = _rope_decode(q, k, pos, cfg, positions_3d)
    n = ck.blocks[0].shape[2]
    s_cache = n * len(ck.blocks) if ck.dim is not None else n
    if isinstance(pos, torch.Tensor):
        at = (pos % s_cache).reshape(1)
        for c, new in ((ck, k), (cv, v)):
            for blk in c.blocks:
                blk.index_copy_(2, at, new.transpose(1, 2).to(blk.dtype))
    else:
        slot = pos % s_cache
        writers = ([(slot // n, slot % n)] if ck.dim is not None
                   else [(i, slot) for i in range(len(ck.blocks))])
        for i, at in writers:
            for c, new in ((ck.blocks[i], k), (cv.blocks[i], v)):
                c[:, :, at] = new[:, 0].to(device=c.device, dtype=c.dtype)
    qg = q.transpose(1, 2).reshape(b, kv, h // kv, 1, hd)
    held = _holders(ck)
    ks, vs = [ck.blocks[i] for i, _ in held], [cv.blocks[i] for i, _ in held]
    if not gqa_decode.on_card(ks[0]):
        out = _split_softmax(qg, ks, vs, _slot_biases(ck, held, pos, s_cache, window))
    elif len(held) == 1:
        out = gqa_decode.gqa_decode_cuda(qg[:, :, :, 0].to(ks[0].device), ks[0], vs[0], pos,
                                         window).to(qg.device)
    else:
        out = gqa_decode.gqa_decode_split_cuda(qg[:, :, :, 0], ks, vs,
                                               [first for _, first in held], s_cache, pos,
                                               window)
    out = out.reshape(b, h, 1, hd).transpose(1, 2).reshape(b, 1, h * hd)
    return _out_proj(group, out), cache_k, cache_v


def cross_decode_attention(p, x: torch.Tensor, cache_k, cache_v, cfg: ModelConfig
                           ) -> torch.Tensor:
    """The decode token's cross-attention over the encoder's K/V cache (no
    mask, no rotation): [B, 1, D].  A cache held in blocks along ``model``
    is attended split, as :func:`decode_attention`'s."""
    b, h, kv, hd = x.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = (c if isinstance(c, ModelBlocks) else ModelBlocks([c]) for c in (cache_k, cache_v))
    group = _heads_group(p, cfg)
    (q,) = _project_heads(p, group, x, cfg, keys=("wq",))
    qg = q.transpose(1, 2).reshape(b, kv, h // kv, 1, hd)
    held = [i for i, _ in _holders(ck)]
    ks, vs = [ck.blocks[i] for i in held], [cv.blocks[i] for i in held]
    biases = [torch.zeros((1, k.shape[2]), dtype=torch.float32, device=k.device) for k in ks]
    o = _split_softmax(qg, ks, vs, biases)
    o = o.reshape(b, h, 1, hd).transpose(1, 2).reshape(b, 1, h * hd)
    return _out_proj(group, o)


def cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K/V [B, KV, S_enc, hd] of the encoder output,
    on its device (each position's kv heads, gathered, where split)."""
    k, v = _project_heads(p, _heads_group(p, cfg), enc_out, cfg, keys=("wk", "wv"))
    return k.transpose(1, 2), v.transpose(1, 2)
