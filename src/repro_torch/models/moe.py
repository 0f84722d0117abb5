"""Mixture of experts: the port's copy of ``repro/models/moe.py``.

Top-k routing, Switch-style capacity-bounded dispatch through one-hot
einsums, the always-on shared expert (Qwen2-MoE) and the load-balancing
auxiliary loss.  ``_expert_axes`` gives the experts' logical axes.
:func:`moe_apply_shards` is the same function over a batch split into
row shards (a meshed step's data shards).

The sigmoid router (``cfg.router == "sigmoid"``, DeepSeek-V3; port-only)
has a path of its own, :func:`dropless_apply`: scores ``sigmoid(h Wr)`` in
float32, the top ``k`` of ``scores + router_bias`` chosen (the bias moves
the choice, not the weights), the chosen scores normalised (``+1e-20``)
and scaled by ``routed_scaling``, and the ungated shared expert added.
No token is dropped: the (token, expert) pairs are sorted by expert, the
groups' ends counted on the device, and each expert weight is one grouped
product over the contiguous groups (``torch._grouped_mm``; its plain twin
:func:`grouped_swiglu_plain`), with no host synchronisation and no loop
over experts.  A chip that holds a share of the experts
(``cfg.n_experts_held`` from ``cfg.first_expert_held``; expert
parallelism without its exchange) routes over all of them, sorts the
pairs of its own experts first, runs the grouped products over its stack
with the groups' ends of its experts, and adds only their part (with the
shared expert); holding all, it runs the same operations as before.
:data:`ROUTING` keeps what that path's decode steps leave for a reader
who armed it: the groups' counts while a profiler runs, and the chosen
experts of the steps it was armed for; a step replayed from a CUDA graph
writes both into its holder's slots, which the holder hands over after
each replay.

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

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    copy_to_model,
    reduce_from_model,
    row_parallel,
)
from repro_torch.models.base import ParamDecl
from repro_torch.sharding.blocks import model_group
from repro_torch.spans import span

__all__ = ["ROUTING", "RoutingRecord", "dropless_apply", "grouped_swiglu",
           "grouped_swiglu_plain", "moe_decls", "moe_apply", "moe_apply_shards", "route_sigmoid"]

TENSOR_AXIS_SIZE = 16  # production mesh "model" axis; only affects layout


def _expert_axes(cfg: ModelConfig) -> Tuple:
    if cfg.n_experts % TENSOR_AXIS_SIZE == 0:
        return ("expert", "fsdp", None)       # expert parallelism
    return (None, "fsdp", "tensor")           # tensor-parallel experts


def moe_decls(cfg: ModelConfig) -> Dict:
    """The router over all ``n_experts``, the stacks of the experts held."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ax = _expert_axes(cfg)
    dt = cfg.dtype
    held = cfg.experts_held
    decls = {
        "router": ParamDecl((d, e), (None, None), dtype=torch.float32, scale=0.02),
        "w_gate": ParamDecl((held, d, ff), ax, dtype=dt),
        "w_up": ParamDecl((held, d, ff), ax, dtype=dt),
        "w_down": ParamDecl((held, ff, d), (ax[0], ax[2], ax[1]), dtype=dt),
    }
    if cfg.n_shared_experts:
        ffs = cfg.d_ff_shared or cfg.d_ff * cfg.n_shared_experts
        decls.update(
            {
                "shared_gate": ParamDecl((d, ffs), ("fsdp", "tensor"), dtype=dt),
                "shared_up": ParamDecl((d, ffs), ("fsdp", "tensor"), dtype=dt),
                "shared_down": ParamDecl((ffs, d), ("tensor", "fsdp"), dtype=dt),
            }
        )
        if cfg.router == "softmax":
            decls["shared_mix"] = ParamDecl((d, 1), (None, None), dtype=torch.float32)
    if cfg.router == "sigmoid":
        decls["router_bias"] = ParamDecl((e,), (None,), init="zeros", dtype=torch.float32)
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
    gates, ups, downs = (group.local(k) for k in ("w_gate", "w_up", "w_down"))
    n = gates[0].shape[0]                   # the experts each position holds
    if n < xe.shape[0]:                     # experts sharded over model
        pieces = [(xe[i * n:(i + 1) * n].to(w.device),
                   combine[:, :, i * n:(i + 1) * n].to(w.device)) for i, w in enumerate(gates)]
    else:                                   # every expert, split by ff
        pieces = zip(copy_to_model(xe, group.devices), copy_to_model(combine, group.devices))
    parts = [_experts(x_m, *ws, c_m, g, cap) for (x_m, c_m), *ws in zip(pieces, gates, ups, downs)]
    return reduce_from_model(parts, xe.device)


def _shared(p, xf) -> torch.Tensor:
    group = model_group(p, "shared_gate", "shared_up", "shared_down")
    hs = [F.silu(x_m @ q.local("shared_gate")) * (x_m @ q.local("shared_up"))
          for q, x_m in zip(group.views, copy_to_model(xf, group.devices))]
    return row_parallel(hs, group.local("shared_down"), xf.device)


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


# ---------------------------------------------------------------------------
# The sigmoid router's dropless path (DeepSeek-V3)
# ---------------------------------------------------------------------------

class RoutingRecord:
    """What the dropless path's calls leave for a reader who asked for it,
    on the device, with no copy and no synchronisation; unarmed, it keeps
    nothing:

      * ``counts``: once armed for them (:meth:`arm_counts`), each call's
        group ends while a profiler runs (int32 ``[E]``, the cumulative
        tokens per expert that the grouped products read), in call order;
        read them once the profiler has stopped (:meth:`take_counts`, which
        disarms);
      * ``chosen``: once armed for ``n`` decode steps (:meth:`arm`), each of
        those steps' ``[(layer, expert ids [T, k])]``; after ``n`` steps it
        keeps nothing (:meth:`take_chosen`)."""

    def __init__(self):
        self.counts: List[torch.Tensor] = []
        self.counting = False
        self.chosen: List[List[Tuple[int, torch.Tensor]]] = []
        self.steps_left = 0

    def arm(self, steps: int) -> None:
        self.steps_left, self.chosen = steps, [[]]

    def arm_counts(self) -> None:
        self.counting, self.counts = True, []

    def record(self, layer: int, ids: torch.Tensor) -> None:
        if self.steps_left > 0:
            self.chosen[-1].append((layer, ids))

    def end_step(self) -> None:
        """A decode step is over: the next call belongs to the next one."""
        if self.steps_left > 0:
            self.steps_left -= 1
            if self.steps_left:
                self.chosen.append([])

    def counting_now(self) -> bool:
        """Whether a call now keeps its group ends: armed, and a profiler runs
        (in any thread)."""
        return self.counting and torch.autograd.profiler._is_profiler_enabled

    def hand_over(self, layers: Sequence[int], ids: torch.Tensor, ends: torch.Tensor) -> bool:
        """A replayed decode step's routing, kept as its layers' own calls
        would have kept it, then the step's end: ``ids`` [L, T, k] and
        ``ends`` [L, E], what the dropless ``layers`` wrote into their slots
        on the device.  Each buffer it keeps is copied once, now, since the
        next replay writes over it.  Returns whether it kept anything."""
        chosen, counting = self.steps_left > 0, self.counting_now()
        if chosen:
            kept = ids.clone()
            for n, layer in enumerate(layers):
                self.record(layer, kept[n])
        if counting:
            self.counts.extend(ends.clone().unbind(0))
        self.end_step()
        return chosen or counting

    def take_chosen(self) -> List[List[Tuple[int, torch.Tensor]]]:
        out, self.chosen, self.steps_left = self.chosen, [], 0
        return [step for step in out if step]

    def take_counts(self) -> List[torch.Tensor]:
        out, self.counts, self.counting = self.counts, [], False
        return out


#: The process's record of the dropless path: one per process, as the
#: profiler is, so that a caller of ``generate`` (which passes nothing of
#: its own to the layers) can arm it and read it.
ROUTING = RoutingRecord()


def route_sigmoid(p, xf: torch.Tensor, cfg: ModelConfig, *,
                  ids_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokens ``xf`` [T, d] -> (the chosen experts [T, k] int64, their
    weights [T, k] float32); the experts written into ``ids_out`` where
    given."""
    scores = torch.sigmoid(xf.float() @ p["router"])                       # [T, E]
    biased = scores + p["router_bias"]
    k = cfg.n_experts_per_token
    out = None if ids_out is None else (biased.new_empty(ids_out.shape), ids_out)
    ids = torch.topk(biased, k, dim=-1, out=out).indices
    w = scores.gather(-1, ids)
    return ids, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling


def grouped_swiglu(xs: torch.Tensor, ends: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Each expert's SwiGLU over its rows of ``xs`` [P, d]: the rows are
    sorted by expert and ``ends`` (int32 [E]) holds each group's end.  One
    grouped product per weight ([E, d, ff], [E, ff, d])."""
    g = torch._grouped_mm(xs, w_gate, offs=ends)
    u = torch._grouped_mm(xs, w_up, offs=ends)
    return torch._grouped_mm(F.silu(g) * u, w_down, offs=ends)


def grouped_swiglu_plain(xs: torch.Tensor, ends: torch.Tensor, w_gate, w_up, w_down
                         ) -> torch.Tensor:
    """:func:`grouped_swiglu`'s plain twin: each row through its expert's
    weights, gathered row by row (memory ``P`` times an expert's: for
    tests)."""
    rows = torch.arange(xs.shape[0], device=xs.device)
    e = torch.searchsorted(ends, rows.to(ends.dtype), right=True)
    x = xs[:, None]
    h = F.silu(torch.bmm(x, w_gate[e])) * torch.bmm(x, w_up[e])
    return torch.bmm(h, w_down[e])[:, 0]


@functools.lru_cache(maxsize=None)
def _expert_ids(e: int, device: torch.device) -> torch.Tensor:
    return torch.arange(e, device=device)


def dropless_apply(p, x: torch.Tensor, cfg: ModelConfig, *, layer: Optional[int] = None,
                   slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The sigmoid-routed experts and the ungated shared expert of ``x``
    [..., d] (module docstring): [..., d].  ``layer`` (a decode step's)
    names the call to :data:`ROUTING`.  With ``slots`` (a captured decode
    step's: ids [T, k] int64, the held experts' group ends [E held] int32)
    the chosen experts and the group ends are written there and
    :data:`ROUTING` is left alone: the step's holder hands them over after
    each replay
    (:meth:`RoutingRecord.hand_over`)."""
    shape, d, k = x.shape, x.shape[-1], cfg.n_experts_per_token
    xf = x.reshape(-1, d)
    ids_out, ends_out = (None, None) if slots is None else slots
    held = cfg.experts_held
    with span("moe.route"):
        ids, w = route_sigmoid(p, xf, cfg, ids_out=ids_out)
        key, mine = ids, None
        if held < cfg.n_experts:        # the held experts' pairs first, the others last
            local = ids - cfg.first_expert_held
            mine = (local >= 0) & (local < held)
            key = torch.where(mine, local, held)
        sorted_ids, order = torch.sort(key.flatten(), stable=True)
        ends = torch.searchsorted(sorted_ids, _expert_ids(held, x.device), right=True,
                                  out_int32=True, out=ends_out)
    if slots is None:
        if layer is not None:
            ROUTING.record(layer, ids)
        if ROUTING.counting_now():
            ROUTING.counts.append(ends)
    with span("moe.experts"):
        y = grouped_swiglu(xf[order // k], ends, p["w_gate"], p["w_up"], p["w_down"])
        pairs = torch.empty_like(y).index_copy_(0, order, y).view(-1, k, d)
        if mine is not None:            # rows past the held groups' end hold no product
            pairs = torch.where(mine[..., None], pairs, 0.0)
            w = torch.where(mine, w, 0.0)
        out = (pairs * w[..., None]).sum(dim=1).to(x.dtype)
    if cfg.n_shared_experts:
        with span("moe.shared"):
            out = out + _shared(p, xf)
    return out.reshape(shape)
