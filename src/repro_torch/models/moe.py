"""Mixture of experts: the port's copy of ``repro/models/moe.py``.

Top-k routing, Switch-style capacity-bounded dispatch through one-hot
einsums, the always-on shared expert (Qwen2-MoE) and the load-balancing
auxiliary loss.  ``_expert_axes`` gives the experts' logical axes.
:func:`moe_apply_shards` is the same function over a batch split into
row shards (a meshed step's data shards).

Over ``model`` the experts take the reference's two layouts: sharded
(``n_experts % 16 == 0``: each position runs its ``E / M`` experts on their
dispatched slots, which reach it by ``.to``, the all-to-all the
reference's dispatch einsum lowers to) or whole and split by ``ff``; the
shared expert is split by its ``ff``.  Each position combines its own
experts' outputs and the partials are summed over ``model``.  Routing,
capacity and the balance loss run once, on the data shard's first
position.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    copy_to_model,
    partial_product,
    reduce_from_model,
)
from repro_torch.models.base import ParamDecl
from repro_torch.sharding.blocks import model_group

__all__ = ["moe_decls", "moe_apply", "moe_apply_shards"]

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


def _moe_groups(p, xf: torch.Tensor, cfg: ModelConfig):
    """The routed and shared experts over token groups ``xf`` [G, Tg, d]:
    returns (y [G, Tg, d], the top-k one-hots [G, Tg, k, E] float32, the
    router probabilities [G, Tg, E] float32)."""
    g, tg, d = xf.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token

    logits = (xf.float() @ p["router"]).float()                          # [G,Tg,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)                         # [G,Tg,k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    sel_onehot = F.one_hot(idx, e).float()                                # [G,Tg,k,E]

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

    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(xf.dtype), xf)       # [E,G,C,d]
    xe = xe.reshape(e, g * cap, d)
    y = _routed(p, xe, combine.to(xf.dtype), g, cap)

    if cfg.n_shared_experts:
        mix = torch.sigmoid(xf.float() @ p["shared_mix"])
        y = y + (mix.to(xf.dtype) * _shared(p, xf))
    return y, sel_onehot, probs


def _experts(xe, w_gate, w_up, w_down, combine, g: int, cap: int) -> torch.Tensor:
    """Experts' SwiGLU over their slots ``xe`` [E, G*C, d], combined into
    the tokens [G, Tg, d]."""
    h = torch.einsum("etd,edf->etf", xe, w_gate)
    u = torch.einsum("etd,edf->etf", xe, w_up)
    ye = torch.einsum("etf,efd->etd", F.silu(h) * u, w_down)
    ye = ye.reshape(xe.shape[0], g, cap, xe.shape[-1])
    return torch.einsum("gsec,egcd->gsd", combine, ye)


def _routed(p, xe, combine, g: int, cap: int) -> torch.Tensor:
    group = model_group(p, "w_gate", "w_up", "w_down")
    if group is None:
        return _experts(xe, p["w_gate"], p["w_up"], p["w_down"], combine, g, cap)
    home = xe.device
    if p.model_dims("w_gate") == (0,):      # experts sharded over model
        n = xe.shape[0] // group.size
        pieces = [(xe[i * n:(i + 1) * n].to(dev), combine[:, :, i * n:(i + 1) * n].to(dev))
                  for i, dev in enumerate(group.devices)]
    else:                                                   # each expert split by ff
        pieces = list(zip(copy_to_model(xe, group.devices),
                          copy_to_model(combine, group.devices)))
    parts = [_experts(x_m, q.local("w_gate"), q.local("w_up"), q.local("w_down"), c_m, g, cap)
             for q, (x_m, c_m) in zip(group.views, pieces)]
    return reduce_from_model(parts, home)


def _shared(p, xf) -> torch.Tensor:
    group = model_group(p, "shared_gate", "shared_up", "shared_down")
    if group is None:
        sh = F.silu(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        return sh @ p["shared_down"]
    parts = [partial_product(F.silu(x_m @ q.local("shared_gate")) * (x_m @ q.local("shared_up")),
                             q.local("shared_down"))
             for q, x_m in zip(group.views, copy_to_model(xf, group.devices))]
    return reduce_from_model(parts, xf.device, xf.dtype)


def _group_size(cfg: ModelConfig, t: int) -> int:
    tg = min(cfg.router_group_size, t)
    return t if t % tg else tg


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, d], aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    t = b * s
    tg = _group_size(cfg, t)
    y, sel_onehot, probs = _moe_groups(p, x.reshape(t // tg, tg, d), cfg)
    # Load-balancing aux loss (Switch): E * mean_e(frac_tokens_e * mean_prob_e).
    frac = sel_onehot.sum(dim=2).mean(dim=(0, 1))                         # [E]
    mean_p = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac / k * mean_p)
    return y.reshape(b, s, d), aux


def moe_apply_shards(ps: Sequence, xs: Sequence[torch.Tensor], cfg: ModelConfig
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """:func:`moe_apply` of the batch ``xs`` split into row shards (each
    [B_i, S, d] on its device; ``ps[i]`` the MoE parameters as shard ``i``
    reads them): the same function of the whole batch.

    The tokens are grouped as the whole batch groups them, ``Tg`` of the
    joined tokens in order.  Each group runs on the shard holding its first
    token; a group that spans shards takes its other tokens from the shards
    that hold them, and its outputs go back to them.  The balance loss is
    the product of the whole batch's means: each group's top-k counts and
    router probabilities are summed, over all shards, before the product.
    Returns (each shard's y, the aux loss on the first shard's device)."""
    s, d = xs[0].shape[1], xs[0].shape[2]
    e, k = cfg.n_experts, cfg.n_experts_per_token
    flat = [x.reshape(-1, d) for x in xs]
    starts = [0]
    for f in flat:
        starts.append(starts[-1] + f.shape[0])
    t = starts[-1]
    tg = _group_size(cfg, t)

    def pieces(lo: int, hi: int):
        """(shard, local start, local stop) covering tokens [lo, hi)."""
        for i, f in enumerate(flat):
            a, b = max(lo, starts[i]), min(hi, starts[i + 1])
            if a < b:
                yield i, a - starts[i], b - starts[i]

    outs = [[] for _ in flat]               # per shard: (local start, y rows)
    home = xs[0].device
    counts = torch.zeros(e, dtype=torch.float32, device=home)
    psum = torch.zeros(e, dtype=torch.float32, device=home)
    owner_groups: Dict[int, List[int]] = {}
    for g in range(t // tg):
        owner = next(pieces(g * tg, g * tg + 1))[0]
        owner_groups.setdefault(owner, []).append(g)
    for owner, groups in owner_groups.items():
        lo, hi = groups[0] * tg, (groups[-1] + 1) * tg
        dev = xs[owner].device
        xg = torch.cat([flat[i][a:b].to(dev) for i, a, b in pieces(lo, hi)])
        y, sel_onehot, probs = _moe_groups(ps[owner], xg.reshape(len(groups), tg, d), cfg)
        counts = counts + sel_onehot.sum(dim=(0, 1, 2)).to(home)
        psum = psum + probs.sum(dim=(0, 1)).to(home)
        y = y.reshape(-1, d)
        for i, a, b in pieces(lo, hi):
            off = starts[i] + a - lo
            outs[i].append((a, y[off:off + (b - a)].to(xs[i].device)))
    frac, mean_p = counts / t, psum / t
    aux = e * torch.sum(frac / k * mean_p)
    ys = [torch.cat([r for _, r in sorted(o, key=lambda q: q[0])]).reshape(x.shape)
          for o, x in zip(outs, xs)]
    return ys, aux
