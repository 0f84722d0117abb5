"""Multi-head latent attention (MLA; DeepSeek-V2, arXiv:2405.04434, as
DeepSeek-V3 uses it without a query low-rank).  A port-only module: the
reference has no latent attention.

Per token ``h`` [d]:

  * ``q = h Wq`` split per head into ``q_nope`` (``qk_nope_head_dim``) and
    ``q_rope`` (``qk_rope_head_dim``);
  * ``[c, k_r] = h Wkv_a``: the latent ``c`` (``kv_lora_rank``) through its
    RMSNorm (:data:`LATENT_NORM_EPS`) and one rotary key ``k_r`` shared by
    all heads;
  * ``[k_nope, v] = c Wkv_b`` per head (``Wkv_b`` [r, H * (nope + v)], each
    head's nope columns then its v columns);
  * rotary over adjacent pairs (``layers.rope_pairs``) on ``q_rope`` and
    ``k_r``; scores ``[q_nope, q_rope] . [k_nope, k_r] / sqrt(nope + rope)``,
    causal softmax (float32), the values, ``Wo``.

:func:`mla_apply` computes that form over a sequence (prefill, training).
:func:`mla_decode` serves one token against a latent cache that holds, a
position, ``c`` after its norm and ``k_r`` after its rotation
(``[B, S, r]`` and ``[B, S, rope]``, masked past ``pos``), with the angles
and the mask the step makes once (:func:`step_terms`); no per-head key
or value is ever made.  It absorbs ``Wkv_b``'s key half into the query
(``q_lat = q_nope W_UK``, scores ``q_lat . c + q_rope . k_r``) and its
value half into the output (``(P c) W_UV``, then ``Wo``): the same
function, whose work a position grows with ``r + rope`` and not with the
heads' keys and values.

With ``cfg.mla_rope`` False (NoPE: Kimi Linear's ``mla_use_nope``) nothing
is rotated: ``q_rope`` and ``k_r`` keep their width and enter the scores
as they are projected, in both forms.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import _bias, chunked_attention
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import (_rope_angles, rmsnorm, rmsnorm_decls, rope_pairs,
                                       rotate_pairs)
from repro_torch.spans import span

__all__ = ["LATENT_NORM_EPS", "init_latent_cache", "mla_apply", "mla_decls", "mla_decode",
           "step_terms"]

#: The latent's RMSNorm epsilon: the published code leaves that norm at its
#: default while the others take ``rms_norm_eps``.
LATENT_NORM_EPS = 1e-6


def mla_decls(cfg: ModelConfig) -> Dict:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, v, dt = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.dtype
    return {
        "wq": ParamDecl((d, h * (nope + rope)), ("fsdp", "tensor"), dtype=dt),
        "wkv_a": ParamDecl((d, r + rope), ("fsdp", None), dtype=dt),
        "kv_norm": rmsnorm_decls(r),
        "wkv_b": ParamDecl((r, h * (nope + v)), (None, "tensor"), dtype=dt),
        "wo": ParamDecl((h * v, d), ("tensor", "fsdp"), dtype=dt),
    }


def _project(p, x: torch.Tensor, cfg: ModelConfig, rotate):
    """``x`` [B, S, d] -> (q_nope [B, S, H, nope], the rotated q_rope [B, S,
    H, rope], the normed latent c [B, S, r], the rotated k_r [B, S, rope]).
    The query's and the key's rotary parts turn in one call of ``rotate``
    (``[B, S, H + 1, rope]`` -> the same, rotated); under NoPE they do not
    turn."""
    b, s, _ = x.shape
    h, nope, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (x @ p["wq"]).view(b, s, h, -1)
    kv = x @ p["wkv_a"]
    c = rmsnorm(p["kv_norm"], kv[..., :r], LATENT_NORM_EPS)
    if not cfg.mla_rope:
        return q[..., :nope], q[..., nope:], c, kv[..., r:]
    rot = rotate(torch.cat([q[..., nope:], kv[..., None, r:]], dim=2))
    return q[..., :nope], rot[:, :, :h], c, rot[:, :, h]


def mla_apply(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Causal latent attention over ``x`` [B, S, d] at ``positions`` [B, S]
    (no cache): [B, S, d], through ``attention.chunked_attention`` (its
    scale ``1/sqrt(nope + rope)``, the query's width)."""
    b, s, _ = x.shape
    h, nope, rope, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c, k_r = _project(p, x, cfg,
                                      lambda t: rope_pairs(t, positions, cfg.rope_theta))
    k_nope, v = (c @ p["wkv_b"]).view(b, s, h, nope + vd).split([nope, vd], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)                 # [B, H, S, qk]
    k = torch.cat([k_nope, k_r[:, :, None].expand(b, s, h, rope)], dim=-1).transpose(1, 2)
    out = chunked_attention(q, k, v.transpose(1, 2), causal=True)            # [B, H, S, v]
    return out.transpose(1, 2).reshape(b, s, h * vd) @ p["wo"]


def init_latent_cache(batch: int, cfg: ModelConfig, max_seq: int, device=None
                      ) -> Dict[str, torch.Tensor]:
    """A layer's latent cache: zeros ``c`` [B, max_seq, r] and ``k_r`` [B,
    max_seq, rope] in ``cfg.dtype``."""
    return {"c": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=cfg.dtype,
                             device=device),
            "k_r": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim), dtype=cfg.dtype,
                               device=device)}


def step_terms(pos, slots: int, cfg: ModelConfig, device) -> Tuple[torch.Tensor, ...]:
    """What every latent-attention layer of the decode step at ``pos``
    shares, made by the step once: the rotation's (sin, cos) ``[1, 1, 1,
    rope/2]`` and the additive mask ``[slots]`` (0 up to ``pos``, then
    NEG_INF).  ``pos`` is an int or a 0-d int64 tensor on ``device``, never
    read back (the same integers, in as many operations)."""
    at = (pos.reshape(1, 1).to(torch.int32) if isinstance(pos, torch.Tensor)
          else torch.full((1, 1), pos, dtype=torch.int32, device=device))
    sin, cos = _rope_angles(at, cfg.qk_rope_head_dim, cfg.rope_theta)
    return sin[:, :, None], cos[:, :, None], _bias(torch.arange(slots, device=device) <= pos)


def mla_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos, cfg: ModelConfig,
               terms: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of ``x`` [B, 1, d] at ``pos`` (an int, or a 0-d int64
    tensor on the card, written by ``index_copy_``: the form a CUDA graph of
    the step replays), with the step's :func:`step_terms`: (out [B, 1, d],
    the cache, written in place at ``pos``).  The key and value halves of
    ``Wkv_b`` are absorbed (module docstring); the scores are the products'
    in ``cfg.dtype`` with the softmax in float32."""
    b = x.shape[0]
    h, nope, vd, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    rope = cfg.qk_rope_head_dim
    with span("mla.attend"):
        sin, cos, mask = terms
        q_nope, q_rope, c, k_r = _project(p, x, cfg, lambda t: rotate_pairs(t, sin, cos))
        for leaf, new in (("c", c), ("k_r", k_r)):
            if isinstance(pos, torch.Tensor):
                cache[leaf].index_copy_(1, pos.reshape(1), new.to(cache[leaf].dtype))
            else:
                cache[leaf][:, pos] = new[:, 0]
        w_b = p["wkv_b"].view(r, h, nope + vd)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_b[..., :nope])        # [B, H, r]
        scores = torch.baddbmm(q_lat @ cache["c"].transpose(1, 2), q_rope[:, 0],
                               cache["k_r"].transpose(1, 2))                      # [B, H, S]
        probs = torch.softmax(scores.float() * (nope + rope) ** -0.5 + mask, dim=-1).to(c.dtype)
        o = torch.einsum("bhr,rhv->bhv", probs @ cache["c"], w_b[..., nope:])     # [B, H, v]
        return o.reshape(b, 1, h * vd) @ p["wo"], cache
