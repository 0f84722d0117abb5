"""Kimi Delta Attention (KDA; "Kimi Linear", arXiv:2510.26692, Sec. 3): a
gated delta-rule linear attention with a per-channel decay.  A port-only
module: the reference has no delta rule.

Per token ``x`` [d] (the block's normed input) and head ``h`` (``n_heads``
heads of ``d_k = d_v = kda_head_dim``; ``K = n_heads * d_k``):

  * ``[q, k, v] = SiLU(conv(x W_qkv))``: one projection to ``3K``, then a
    causal depthwise convolution of ``conv_width`` taps per channel (no
    bias) over the token and the ``conv_width - 1`` before it;
  * ``q`` and ``k`` L2-normalised per head (``x / sqrt(sum x^2 +``
    :data:`L2_EPS` ``)``), ``q`` scaled by ``d_k^-1/2``;
  * ``g = -exp(a_log[h]) * softplus(x W_f_a W_f_b + dt_bias)``: the log
    decay of each key channel ``[K]``, through a low rank of ``d_k``;
  * ``beta = sigmoid(x W_beta)``, one a head;
  * ``S <- (I - beta k k^T) Diag(exp g) S + beta k v^T`` with ``S`` [d_k,
    d_v] in float32: the decay, then the delta rule's rank-1 update
    (``u = k^T S``, ``S += beta k (v - u)^T``);
  * ``o = S^T q``, through an RMSNorm over ``d_v`` (``o_norm``, eps
    ``norm_eps``) times ``sigmoid(x W_g_a W_g_b)`` (a low rank of
    ``d_k``), then ``W_o``.

The projections run in ``cfg.dtype``; the convolution, norms, gates and
the recurrence in float32.  :func:`kda_apply` runs a sequence from a zero
state as a scan over its positions, one decode step of the recurrence
each (prefill; the step writes its state in place and has no backward,
so :func:`kda_apply` refuses to run where a gradient is asked for).
:func:`kda_decode` runs one token on a layer's decode cache ``{S [B, H,
d_k, d_v] float32, conv [B, conv_width - 1, 3K] cfg.dtype}`` (the state
and the last inputs of the convolution) and writes both in place: on the
card the state goes through ``csrc/kda_decode.cu``
(``kernels/kda.kda_decode_cuda``), which reads it once and writes it once,
so a CUDA graph of the step replays with the state carried from step to
step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kda import kda_decode_step
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import rmsnorm_decls
from repro_torch.spans import span

__all__ = ["L2_EPS", "init_kda_cache", "kda_apply", "kda_decls", "kda_decode"]

#: The epsilon of the query's and key's L2 norms (the published kernels' default).
L2_EPS = 1e-6
#: The parameters that reach the recurrence's inputs.
_RECURRENCE_PARAMS = ("w_qkv", "conv", "w_f_a", "w_f_b", "a_log", "dt_bias", "w_beta")


def kda_decls(cfg: ModelConfig) -> Dict:
    d, h, dk, dt = cfg.d_model, cfg.n_heads, cfg.kda_head_dim, cfg.dtype
    kd = h * dk
    return {
        "w_qkv": ParamDecl((d, 3 * kd), ("fsdp", "tensor"), dtype=dt),
        "conv": ParamDecl((cfg.conv_width, 3 * kd), (None, "tensor"), dtype=dt),
        "w_f_a": ParamDecl((d, dk), ("fsdp", None), dtype=dt),
        "w_f_b": ParamDecl((dk, kd), (None, "tensor"), dtype=dt),
        "a_log": ParamDecl((h,), (None,), init="zeros", dtype=torch.float32),
        "dt_bias": ParamDecl((kd,), (None,), init="zeros", dtype=torch.float32),
        "w_beta": ParamDecl((d, h), ("fsdp", None), dtype=dt),
        "w_g_a": ParamDecl((d, dk), ("fsdp", None), dtype=dt),
        "w_g_b": ParamDecl((dk, kd), (None, "tensor"), dtype=dt),
        "o_norm": rmsnorm_decls(dk),
        "wo": ParamDecl((kd, d), ("tensor", "fsdp"), dtype=dt),
    }


def init_kda_cache(batch: int, cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    """A KDA layer's decode cache: zeros ``S`` [B, H, d_k, d_v] float32 and
    ``conv`` [B, conv_width - 1, 3K] in ``cfg.dtype``."""
    h, dk = cfg.n_heads, cfg.kda_head_dim
    return {"S": torch.zeros((batch, h, dk, dk), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, 3 * h * dk), dtype=cfg.dtype,
                                device=device)}


def _heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return t.unflatten(-1, (cfg.n_heads, cfg.kda_head_dim))


def _l2(t: torch.Tensor) -> torch.Tensor:
    return t * torch.rsqrt((t * t).sum(-1, keepdim=True) + L2_EPS)


def _inputs(p, x: torch.Tensor, mixed: torch.Tensor, cfg: ModelConfig):
    """The recurrence's inputs at each position of ``x`` [B, S, d], with
    ``mixed`` [B, S, 3K] float32 the convolution's output: (q, k, v, g
    [B, S, H, d_k] float32, beta [B, S, H] float32)."""
    q, k, v = (_heads(t, cfg) for t in F.silu(mixed).chunk(3, dim=-1))
    q = _l2(q) * cfg.kda_head_dim ** -0.5
    f = ((x @ p["w_f_a"]) @ p["w_f_b"]).float() + p["dt_bias"]
    g = -torch.exp(p["a_log"])[:, None] * _heads(F.softplus(f), cfg)
    beta = torch.sigmoid((x @ p["w_beta"]).float())
    return q, _l2(k), v, g, beta


def _out(p, x: torch.Tensor, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``o`` [B, S, H, d_v] float32 through the gated RMSNorm and ``W_o``."""
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * p["o_norm"]["scale"]
    gate = torch.sigmoid(_heads(((x @ p["w_g_a"]) @ p["w_g_b"]).float(), cfg))
    return (o * gate).flatten(-2).to(x.dtype) @ p["wo"]


def _conv(p, window: torch.Tensor) -> torch.Tensor:
    """The causal depthwise convolution of ``window`` [B, S + W - 1, 3K]
    (the ``W - 1`` inputs before the first position, then the positions'):
    [B, S, 3K] float32."""
    w = p["conv"].float()
    s = window.shape[1] - w.shape[0] + 1
    out = window[:, :s].float() * w[0]
    for j in range(1, w.shape[0]):
        out = out + window[:, j:j + s].float() * w[j]
    return out


def kda_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """KDA over ``x`` [B, S, d] from a zero state: [B, S, d].  Raises
    where autograd would record the recurrence: it has no backward, so a
    gradient would silently miss ``x`` and the parameters before it."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *(p[n] for n in _RECURRENCE_PARAMS))):
        raise NotImplementedError(
            "kda_apply has no backward (the recurrence writes its state in place); "
            "run it under torch.no_grad() or on tensors that need no gradient")
    b, s, _ = x.shape
    pre = x @ p["w_qkv"]
    window = F.pad(pre, (0, 0, cfg.conv_width - 1, 0))
    q, k, v, g, beta = _inputs(p, x, _conv(p, window), cfg)
    state = torch.zeros((b, cfg.n_heads, cfg.kda_head_dim, cfg.kda_head_dim),
                        dtype=torch.float32, device=x.device)
    outs = [kda_decode_step(state, q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t])
            for t in range(s)]
    return _out(p, x, torch.stack(outs, 1), cfg)


def kda_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of ``x`` [B, 1, d]: (out [B, 1, d], the cache, its
    state and convolution inputs written in place)."""
    with span("kda.attend"):
        window = torch.cat([cache["conv"], x @ p["w_qkv"]], dim=1)        # [B, W, 3K]
        q, k, v, g, beta = _inputs(p, x, _conv(p, window), cfg)
        cache["conv"].copy_(window[:, 1:])
        o = kda_decode_step(cache["S"], q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0])
        return _out(p, x, o[:, None], cfg), cache
