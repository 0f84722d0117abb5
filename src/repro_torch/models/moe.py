"""Mixture of experts: the port's copy of ``repro/models/moe.py``.

Top-k routing, Switch-style capacity-bounded dispatch through one-hot
einsums, the always-on shared expert (Qwen2-MoE) and the load-balancing
auxiliary loss.  The expert layout hint (``_expert_axes``) is kept as data
for the sharding half of the LM substrate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamDecl

__all__ = ["moe_decls", "moe_apply"]

TENSOR_AXIS_SIZE = 16  # production mesh "model" axis; only affects layout


def _expert_axes(cfg: ModelConfig) -> Tuple:
    if cfg.n_experts % TENSOR_AXIS_SIZE == 0:
        return ("expert", "fsdp", None)       # expert parallelism
    return (None, "fsdp", "tensor")           # tensor-parallel experts


def moe_decls(cfg: ModelConfig) -> Dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ax = _expert_axes(cfg)
    dt = cfg.dtype
    decls = {
        "router": ParamDecl((d, e), (None, None), dtype=torch.float32, scale=0.02),
        "w_gate": ParamDecl((e, d, ff), ax, dtype=dt),
        "w_up": ParamDecl((e, d, ff), ax, dtype=dt),
        "w_down": ParamDecl((e, ff, d), (ax[0], ax[2], ax[1]), dtype=dt),
    }
    if cfg.n_shared_experts:
        ffs = cfg.d_ff_shared or cfg.d_ff * cfg.n_shared_experts
        decls.update(
            {
                "shared_gate": ParamDecl((d, ffs), ("fsdp", "tensor"), dtype=dt),
                "shared_up": ParamDecl((d, ffs), ("fsdp", "tensor"), dtype=dt),
                "shared_down": ParamDecl((ffs, d), ("tensor", "fsdp"), dtype=dt),
                "shared_mix": ParamDecl((d, 1), (None, None), dtype=torch.float32),
            }
        )
    return decls


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, d], aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    t = b * s
    tg = min(cfg.router_group_size, t)
    if t % tg:
        tg = t
    g = t // tg
    xf = x.reshape(g, tg, d)

    logits = (xf.float() @ p["router"]).float()                          # [G,Tg,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)                         # [G,Tg,k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Load-balancing aux loss (Switch): E * mean_e(frac_tokens_e * mean_prob_e).
    sel_onehot = F.one_hot(idx, e).float()                                # [G,Tg,k,E]
    frac = sel_onehot.sum(dim=2).mean(dim=(0, 1))                         # [E]
    mean_p = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac / k * mean_p)

    cap = max(4, int(tg * k / e * cfg.capacity_factor))
    # Position of each (token, k) assignment within its expert, per group.
    flat_sel = sel_onehot.reshape(g, tg * k, e)
    pos = torch.cumsum(flat_sel, dim=1) * flat_sel - 1.0                  # [G,Tg*k,E]
    pos = pos.reshape(g, tg, k, e)
    # A slot not selected (-1) or over capacity (>= cap) has no one-hot row:
    # clamp it into range, then zero it.
    within = (pos >= 0) & (pos < cap)
    pos_oh = F.one_hot(pos.long().clamp(0, cap - 1), cap).float() * within[..., None]

    # dispatch [G,Tg,E,C] (0/1); combine adds the gate weight.
    dispatch = pos_oh.sum(dim=2)
    combine = torch.einsum("gsk,gske,gskec->gsec", gate_vals, sel_onehot, pos_oh)

    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xf)        # [E,G,C,d]
    xe = xe.reshape(e, g * cap, d)
    h = torch.einsum("etd,edf->etf", xe, p["w_gate"])
    u = torch.einsum("etd,edf->etf", xe, p["w_up"])
    ye = torch.einsum("etf,efd->etd", F.silu(h) * u, p["w_down"])
    ye = ye.reshape(e, g, cap, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), ye)

    if cfg.n_shared_experts:
        sh = F.silu(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        sh = sh @ p["shared_down"]
        mix = torch.sigmoid(xf.float() @ p["shared_mix"])
        y = y + (mix.to(x.dtype) * sh)

    return y.reshape(b, s, d), aux
