"""A plain float32 reference of the DeepSeek-V3 decoder (Moonlight-16B-A3B's
block; arXiv:2412.19437, latent attention from arXiv:2405.04434) for the
CPU tests of the port's latent attention and sigmoid-routed experts.

Plain ``torch``, TF32 off, no cache: the whole sequence through every
layer, causally masked.  It imports nothing of the port.  ``cfg`` holds the
model's ``config.json`` keys; ``weights`` are tensors by the port's
parameter names, each matrix applied as ``x @ W``.  Per layer (pre-norm
residual; RMSNorm ``x * rsqrt(mean(x^2) + eps) * scale``, eps
``rms_norm_eps``):

  * ``q = h Wq`` split per head into nope and rope parts; ``[c, k_r] = h
    Wkv_a``, ``c`` through its RMSNorm at eps 1e-6; ``[k_nope, v] = c
    Wkv_b`` per head; ``q_rope`` and the shared ``k_r`` rotated over
    adjacent pairs ``(2i, 2i+1)`` at ``rope_theta^(-2i/rope)`` (angles in
    float64); softmax of ``q . k / sqrt(nope + rope)`` under the causal
    mask; the values; ``Wo``;
  * the first ``first_k_dense_replace`` layers: a SwiGLU;
  * the others: the top ``num_experts_per_tok`` of ``sigmoid(h Wr) +
    e_score_correction_bias`` (``router_bias``), weighted by the sigmoid
    scores at them over their sum (+1e-20) times
    ``routed_scaling_factor``, each through its own SwiGLU, plus the
    ungated shared SwiGLU;

then a final RMSNorm and the untied head.  No departure from the
published equations but the missing multi-token prediction module (the
model has none).  ``route`` may replace the top-k choice (for tests that
route every token one way).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

__all__ = ["logits"]


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rotate(x, positions, theta):
    dim = x.shape[-1]
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ang = positions.to(torch.float64)[:, None] * inv
    sin, cos = ang.sin().float(), ang.cos().float()
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def _swiglu(x, g, u, d):
    return (F.silu(x @ g) * (x @ u)) @ d


def _attend(h, w, cfg):
    b, s, _ = h.shape
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    pos = torch.arange(s)
    q = (h @ w["attn.wq"]).view(b, s, nh, nope + rope)
    kv = h @ w["attn.wkv_a"]
    c = _norm(kv[..., :r], w["attn.kv_norm.scale"], 1e-6)
    kvb = (c @ w["attn.wkv_b"]).view(b, s, nh, nope + vd)
    k_r = _rotate(kv[..., r:], pos, cfg["rope_theta"])                        # [b, s, rope]
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:].transpose(1, 2), pos,
                                          cfg["rope_theta"]).transpose(1, 2)], dim=-1)
    k = torch.cat([kvb[..., :nope], k_r[:, :, None].expand(b, s, nh, rope)], dim=-1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(nope + rope)
    causal = pos[None, :] <= pos[:, None]
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhv->bqhv", att, kvb[..., nope:])
    return out.reshape(b, s, nh * vd) @ w["attn.wo"]


def _moe(h, w, cfg, route):
    d, k = h.shape[-1], cfg["num_experts_per_tok"]
    x = h.reshape(-1, d)
    scores = torch.sigmoid(x @ w["moe.router"])
    ids = torch.topk(scores + w["moe.router_bias"], k, dim=-1).indices
    if route is not None:
        ids = route(ids)
    wts = scores.gather(-1, ids)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(k):
            e = int(ids[t, j])
            out[t] += wts[t, j] * _swiglu(x[t], w["moe.w_gate"][e], w["moe.w_up"][e],
                                          w["moe.w_down"][e])
    out = out + _swiglu(x, w["moe.shared_gate"], w["moe.shared_up"], w["moe.shared_down"])
    return out.view(h.shape)


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
           route: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Float32 logits ``[N, S, V]`` of ``tokens`` ``[N, S]`` at every
    position.  ``route(ids)`` may replace each MoE layer's chosen experts
    ``[T, k]``."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        w = {k: v.float() for k, v in weights.items()}
        eps = cfg["rms_norm_eps"]
        x = F.embedding(tokens.long(), w["embed.tok"])
        for i in range(cfg["num_hidden_layers"]):
            lw = {k[len(f"layers.{i}."):]: v for k, v in w.items()
                  if k.startswith(f"layers.{i}.")}
            x = x + _attend(_norm(x, lw["attn_norm.scale"], eps), lw, cfg)
            m = _norm(x, lw["mlp_norm.scale"], eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + _swiglu(m, lw["mlp.w_gate"], lw["mlp.w_up"], lw["mlp.w_down"])
            else:
                x = x + _moe(m, lw, cfg, route)
        return _norm(x, w["final_norm.scale"], eps) @ w["embed.head"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
