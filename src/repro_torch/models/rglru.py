"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
port's copy of ``repro/models/rglru.py``.

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t)                 (recurrence gate)
    i_t = sigmoid(W_x x_t)                 (input gate)
    a_t = a^(c * r_t)        with a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A diagonal linear recurrence: the full sequence runs as a parallel prefix
scan over (a_t, b_t) pairs in log2(S) steps (Hillis-Steele; the
reference's ``lax.associative_scan`` combines in another tree order, so
the two agree to rounding), decode as a one-step update.  The residual
block is conv1d(W_x branch) -> RG-LRU -> gated (gelu) merge -> out
projection, as in the Griffin recurrent block.

One body, split over ``model`` by channel (one position with every
channel when unmeshed): each position runs ``w_x``, ``w_gate``, the conv and
the recurrence on its channels; the ``(w, w)`` gate matrices read the
whole width, so the conv's output is gathered over ``model`` before them;
``w_out`` is row-parallel and the partials are summed.  A decode state
laid out by ``tensor`` (:class:`ModelBlocks`) holds each position's
channels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import copy_to_model, gather_from_model, row_parallel
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import gelu, rmsnorm, rmsnorm_decls
from repro_torch.sharding.blocks import (
    ModelBlocks,
    model_group,
    state_blocks,
    state_like,
    whole_group,
)

_SPLIT = ("w_x", "w_gate", "conv_w", "conv_b", "gate_a", "gate_x", "w_out")

__all__ = [
    "rglru_decls",
    "rglru_apply",
    "rglru_decode",
    "rglru_init_state",
]

_C = 8.0
_MAX_LOG = -8.0  # softplus-parameterized min decay (Griffin's Lambda init)


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.rglru_lru_width or cfg.d_model


def rglru_decls(cfg: ModelConfig) -> Dict:
    d, w = cfg.d_model, _lru_width(cfg)
    dt = cfg.dtype
    return {
        "norm": rmsnorm_decls(d),
        "w_x": ParamDecl((d, w), ("fsdp", "tensor"), dtype=dt),
        "w_gate": ParamDecl((d, w), ("fsdp", "tensor"), dtype=dt),
        "conv_w": ParamDecl((cfg.conv_width, w), (None, "tensor"), dtype=dt, scale=0.1),
        "conv_b": ParamDecl((w,), ("tensor",), dtype=dt, init="zeros"),
        "gate_a": ParamDecl((w, w), ("fsdp", "tensor"), dtype=dt, scale=0.02),
        "gate_x": ParamDecl((w, w), ("fsdp", "tensor"), dtype=dt, scale=0.02),
        "lambda_p": ParamDecl((w,), (None,), dtype=torch.float32, init="ones"),
        "w_out": ParamDecl((w, d), ("tensor", "fsdp"), dtype=dt),
    }


def rglru_init_state(batch: int, cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    w = _lru_width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=torch.float32, device=device),
    }


def _log_a(lambda_p: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """log a_t = c * r_t * log sigmoid(Lambda); fp32, strictly negative."""
    r = torch.sigmoid(gx)
    log_a_base = F.logsigmoid(_MAX_LOG * F.softplus(lambda_p))
    return _C * r * log_a_base[None]


def _conv1d(p, x: torch.Tensor, history: Optional[torch.Tensor]) -> torch.Tensor:
    """Causal depthwise conv over time. x [B, S, W]; history [B, cw-1, W];
    ``p`` holds ``conv_w`` and ``conv_b`` (a position's blocks when split)."""
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    cw = conv_w.shape[0]
    if history is None:
        history = torch.zeros((x.shape[0], cw - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = sum(xp[:, i : i + x.shape[1]] * conv_w[i][None, None] for i in range(cw))
    return out + conv_b[None, None]


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0, over axis 1: an inclusive
    prefix scan of the pairs under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a_prev], dim=1)
        step *= 2
    return b


def _gates(lambda_p, gate_a, gate_x, uf: torch.Tensor, u_own: torch.Tensor):
    """(a_t, the recurrence's input b_t) of the channels of ``gate_a``/
    ``gate_x``'s columns: ``uf`` the whole conv output in float32, ``u_own``
    those channels' part."""
    log_a = _log_a(lambda_p, uf @ gate_a.float())
    ig = torch.sigmoid(uf @ gate_x.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * ig * u_own


def _split_parts(p, xn: torch.Tensor, group, history=None):
    """Each position's (conv input, conv output in float32, gate, lambda_p
    block, gate matrices, w_out block) and the whole conv output in float32
    on each position."""
    parts = []
    for i, (q, xm) in enumerate(zip(group.views, copy_to_model(xn, group.devices))):
        ux = xm @ q.local("w_x")
        h = None if history is None else history[i]
        u = _conv1d({"conv_w": q.local("conv_w"), "conv_b": q.local("conv_b")}, ux, h).float()
        n = u.shape[-1]
        lam = q.local("lambda_p")[i * n:(i + 1) * n]
        parts.append((ux, u, gelu(xm @ q.local("w_gate")), lam, q.local("gate_a"),
                      q.local("gate_x"), q.local("w_out")))
    whole = gather_from_model([pt[1] for pt in parts], -1, group.devices)
    return parts, whole


def rglru_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence recurrent block: [B, S, d] -> [B, S, d] (residual in)."""
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    group = model_group(p, *_SPLIT)
    parts, whole = _split_parts(p, xn, group)
    ys, w_outs = [], []
    for (_, u, gate, lam, ga, gx, w_out), uw in zip(parts, whole):
        a, b = _gates(lam, ga, gx, uw, u)
        ys.append(_linear_scan(a, b).to(x.dtype) * gate)
        w_outs.append(w_out)
    return x + row_parallel(ys, w_outs, x.device)


def rglru_decode(
    p, x: torch.Tensor, state: Dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x [B, 1, d] -> (y [B, 1, d], new state).  A state in
    blocks along ``model`` (:class:`ModelBlocks`, channels split) runs split;
    one held whole (a tensor, or a copy on each position) runs whole and
    is laid out again as it came."""
    split = isinstance(state["h"], ModelBlocks) and state["h"].dim is not None
    group = model_group(p, *_SPLIT) if split else whole_group(p)
    h_held, conv_held = (state_blocks(state[k], group.size, x.device) for k in ("h", "conv"))
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    parts, whole = _split_parts(p, xn, group, conv_held)
    ys, w_outs, hs, convs = [], [], [], []
    for (ux, u, gate, lam, ga, gx, w_out), uw, h, conv in zip(parts, whole, h_held, conv_held):
        a, b = _gates(lam, ga, gx, uw[:, 0], u[:, 0])
        hs.append(a * h + b)
        convs.append(torch.cat([conv[:, 1:], ux.float()], dim=1))
        ys.append(hs[-1][:, None].to(x.dtype) * gate)
        w_outs.append(w_out)
    return x + row_parallel(ys, w_outs, x.device), {"h": state_like(state["h"], hs, 1),
                                                    "conv": state_like(state["conv"], convs, 2)}
