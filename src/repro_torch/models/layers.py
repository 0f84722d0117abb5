"""Shared layers: the port's copy of ``repro/models/layers.py``.

RMSNorm, logit soft-capping, RoPE (GPT-NeoX half rotation; DeepSeek's
rotation of adjacent pairs) and Qwen2-VL's M-RoPE, the gated MLP (SwiGLU / GeGLU), the token embedding, the LM head
and its cross entropy.  Casts sit where the reference has them: norms,
rotations and soft-capping compute in float32 (:func:`wide`: float64
stays float64) and return the input's dtype.

Each layer has one body, over the positions of its model group
(``sharding/blocks.py:model_group``), each on its own block: the MLP
column-parallel in ``w_gate``/``w_up`` and row-parallel in ``w_down``, the
embedding, head and cross entropy vocab-parallel; the positions' results
are combined by the model-axis operators (``distributed/collectives.py``).
Unmeshed, or where a mesh does not split the layer, the group is one
position holding the leaves whole and the operators are the identity.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    row_parallel,
)
from repro_torch.models.base import ParamDecl
from repro_torch.sharding.blocks import model_group

__all__ = [
    "rmsnorm_decls",
    "rmsnorm",
    "rope",
    "rope_pairs",
    "rotate_pairs",
    "mrope",
    "mlp_decls",
    "mlp",
    "embed_decls",
    "embed_lookup",
    "lm_logits",
    "softcap",
    "token_xent",
    "wide",
]


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for the reference's float32 casts, or as it is when
    it is float64, so a float64 dense decoder computes in float64 (the
    full-width gradient witness of ``chip_smoke.py``)."""
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_decls(d: int) -> Dict:
    return {"scale": ParamDecl((d,), (None,), init="ones", dtype=torch.float32)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = wide(x)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * p["scale"]
    return y.to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(wide(x) / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (GPT-NeoX half-rotation convention)
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (sin, cos) [..., dim/2] in fp32."""
    # log(theta) in float32, as the reference takes it, from the host (a
    # tensor made from a Python number would be a copy to the device).
    log_theta = float(np.log(np.float32(theta)))
    arange = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-log_theta * arange / dim)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def _apply_rot(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [..., hd]; sin/cos broadcastable [..., hd/2]."""
    half = x.shape[-1] // 2
    x1f, x2f = wide(x[..., :half]), wide(x[..., half:])
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE. x [B, S, H, hd]; positions [B, S] (or [S])."""
    if positions.ndim == 1:
        positions = positions[None]
    sin, cos = _rope_angles(positions, x.shape[-1], theta)      # [B, S, hd/2]
    return _apply_rot(x, sin[:, :, None, :], cos[:, :, None, :])


def rope_pairs(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE over adjacent pairs: ``(x[2i], x[2i+1])`` rotated by position times
    ``theta^(-2i/hd)`` (DeepSeek's layout, HF's ``rope_interleave``, which
    de-interleaves q and k alike first: the same scores).  x [B, S, H, hd];
    positions [B, S] (or [S])."""
    if positions.ndim == 1:
        positions = positions[None]
    sin, cos = _rope_angles(positions, x.shape[-1], theta)      # [B, S, hd/2]
    return rotate_pairs(x, sin[:, :, None, :], cos[:, :, None, :])


def rotate_pairs(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """:func:`rope_pairs` with its angles given: x [..., hd]; sin/cos
    broadcastable [..., hd/2] (fp32)."""
    pairs = wide(x).unflatten(-1, (-1, 2))
    x1, x2 = pairs[..., 0], pairs[..., 1]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2).to(x.dtype)


def mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    Args:
      x: [B, S, H, hd].
      positions: [3, B, S]: temporal / height / width position ids (all
        equal for pure text).
      sections: per-axis number of *pairs*; sums to hd/2 (e.g. (16, 24, 24)
        for hd=128).
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} != head_dim/2 = {hd // 2}")
    sins, coss = [], []
    for i, sec in enumerate(sections):
        # Each section uses its own position stream but the global
        # frequency table's slice [offset : offset+sec], as HF does.
        s, c = _rope_angles(positions[i], hd, theta)             # [B, S, hd/2]
        off = sum(sections[:i])
        sins.append(s[..., off : off + sec])
        coss.append(c[..., off : off + sec])
    sin = torch.cat(sins, dim=-1)
    cos = torch.cat(coss, dim=-1)
    return _apply_rot(x, sin[:, :, None, :], cos[:, :, None, :])


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU/GeGLU)
# ---------------------------------------------------------------------------

def mlp_decls(d: int, ff: int, dtype=torch.bfloat16) -> Dict:
    return {
        "w_gate": ParamDecl((d, ff), ("fsdp", "tensor"), dtype=dtype),
        "w_up": ParamDecl((d, ff), ("fsdp", "tensor"), dtype=dtype),
        "w_down": ParamDecl((ff, d), ("tensor", "fsdp"), dtype=dtype),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = F.silu if activation == "silu" else gelu
    group = model_group(p, "w_gate", "w_up", "w_down")
    hs = [act(xm @ q.local("w_gate")) * (xm @ q.local("w_up"))
          for q, xm in zip(group.views, copy_to_model(x, group.devices))]
    return row_parallel(hs, group.local("w_down"), x.device)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_decls(cfg: ModelConfig) -> Dict:
    d = {
        "tok": ParamDecl(
            (cfg.vocab_size, cfg.d_model), ("tensor", "fsdp"),
            dtype=cfg.dtype, init="embed", scale=0.02,
        )
    }
    if not cfg.tie_embeddings:
        d["head"] = ParamDecl(
            (cfg.d_model, cfg.vocab_size), ("fsdp", "tensor"), dtype=cfg.dtype
        )
    return d


def _vocab_range(tokens: torch.Tensor, m: int, n: int):
    """(the ids local to position ``m``'s ``n`` vocab entries, clamped into
    range; where the ids are another position's)."""
    t = tokens - m * n
    return t.clamp(0, n - 1), (t < 0) | (t >= n)


def embed_lookup(p, tokens: torch.Tensor) -> torch.Tensor:
    # Vocab-parallel: each position looks up the ids in its range, zeros
    # elsewhere; the sum has one nonzero term per row, so it is exact.
    parts = []
    for m, tok in enumerate(model_group(p, "tok").local("tok")):
        t, other = _vocab_range(tokens.to(tok.device), m, tok.shape[0])
        parts.append(F.embedding(t, tok).masked_fill_(other[..., None], 0))
    return reduce_from_model(parts, tokens.device)


def _head_blocks(p, cfg: ModelConfig, group) -> list:
    """Each position's columns of the LM head ([d, V / M])."""
    if cfg.tie_embeddings:
        return [t.T for t in group.local("tok")]
    return group.local("head")


def lm_logits(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    group = model_group(p, "tok" if cfg.tie_embeddings else "head")
    parts = [xm @ w for xm, w in zip(copy_to_model(x, group.devices),
                                     _head_blocks(p, cfg, group))]
    return gather_from_model(parts, -1, [x.device])[0]


def token_xent(p, h: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig,
               cap: Optional[float]) -> torch.Tensor:
    """Each position's cross entropy ``logsumexp(logits) - logits[target]``
    (float32; float64 for float64 activations), the logits ``softcap(h @
    head, cap)``.  Vocab-parallel: each position takes its columns'
    logits and their ``logsumexp``, the positions' are combined by a
    ``logsumexp`` over them (one position's is itself, forward and
    backward), and the target's logit comes from the position that holds
    it."""
    group = model_group(p, "tok" if cfg.tie_embeddings else "head")
    lses, tgts = [], []
    for m, (hm, w) in enumerate(zip(copy_to_model(h, group.devices), _head_blocks(p, cfg, group))):
        lg = softcap(wide(hm @ w), cap)
        lses.append(torch.logsumexp(lg, dim=-1, keepdim=True))
        t, other = _vocab_range(targets.to(lg.device), m, lg.shape[-1])
        tgts.append(lg.gather(-1, t[..., None])[..., 0].masked_fill_(other, 0))
    lse = torch.logsumexp(gather_from_model(lses, -1, [h.device])[0], dim=-1)
    return lse - reduce_from_model(tgts, h.device)
