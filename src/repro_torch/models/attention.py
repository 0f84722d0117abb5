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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import mrope, rope, wide

__all__ = [
    "attention_decls",
    "attention_apply",
    "cache_len",
    "chunked_attention",
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
    """Memory-bounded attention over query chunks; returns [B, H, Sq, hd].

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
    return out.reshape(b, h, sq, hd)


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
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], h, hd)
    src = x if kv_source is None else kv_source
    k = _split_heads(src @ p["wk"], kv, hd)
    vv = _split_heads(src @ p["wv"], kv, hd)
    if use_rope and kv_source is None:
        if cfg.mrope_sections is not None:
            q = mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    out = chunked_attention(
        q.transpose(1, 2), k.transpose(1, 2), vv.transpose(1, 2),
        causal=causal and kv_source is None,
        window=window,
        chunk=chunk,
    )
    out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], h * hd)
    return out @ p["wo"]


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


def decode_attention(
    p,
    x: torch.Tensor,                     # [B, 1, D] current token activations
    cache_k: torch.Tensor,               # [B, KV, S_cache, hd]
    cache_v: torch.Tensor,
    pos: int,                            # current position
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    positions_3d: Optional[torch.Tensor] = None,  # [3, B, 1] for M-RoPE decode
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step; returns (out [B, 1, D], cache_k, cache_v).

    The new key and value are written into the caches in place, at slot
    ``pos % S_cache`` (a ring for windowed caches, ``pos`` itself for full
    ones).  Masking rebuilds each slot's absolute position from the write
    position, so both layouts share one code path."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_cache = cache_k.shape[2]
    dev = x.device

    q = _split_heads(x @ p["wq"], h, hd)              # [B, 1, H, hd]
    k = _split_heads(x @ p["wk"], kv, hd)
    v = _split_heads(x @ p["wv"], kv, hd)
    if cfg.mrope_sections is not None:
        p3 = positions_3d
        if p3 is None:
            p3 = torch.full((3, b, 1), pos, dtype=torch.int32, device=dev)
        q = mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = mrope(k, p3, cfg.rope_theta, cfg.mrope_sections)
    else:
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        q = rope(q, posb, cfg.rope_theta)
        k = rope(k, posb, cfg.rope_theta)

    slot = pos % s_cache
    cache_k[:, :, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, slot] = v[:, 0].to(cache_v.dtype)

    # Absolute position of each ring slot given the current write pos.
    slots = torch.arange(s_cache, device=dev)
    base = pos - slot                                  # start of current wrap
    abs_pos = torch.where(slots <= slot, base + slots, base - s_cache + slots)
    ok = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        ok &= pos - abs_pos < window
    bias = _bias(ok)                                   # [S_cache]

    g = h // kv
    qg = q.transpose(1, 2).reshape(b, kv, g, 1, hd)
    out = _sdpa(qg, cache_k, cache_v, bias[None, :])
    out = out.reshape(b, kv * g, 1, hd).transpose(1, 2).reshape(b, 1, h * hd)
    return out @ p["wo"], cache_k, cache_v
