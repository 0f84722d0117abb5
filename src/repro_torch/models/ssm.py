"""xLSTM blocks (Beck et al., arXiv:2405.04517), mLSTM and sLSTM: the port's
copy of ``repro/models/ssm.py``.

mLSTM: matrix-memory LSTM with exponential gating.  The full sequence runs
in the chunkwise-parallel form (quadratic within a chunk, linear across
chunks with a carried (C, n, m) state and log-space stabilisation); decode
runs the exact one-step recurrence.  Cell (per head):

    m_t = max(lf_t + m_{t-1}, i_t)
    C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) k_t v_t^T
    n_t = exp(lf_t + m_{t-1} - m_t) n_{t-1} + exp(i_t - m_t) k_t
    h_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t))

sLSTM: scalar-memory LSTM with exponential gating and a per-head
block-diagonal recurrence; sequential over time.

Block layout follows the paper: mLSTM blocks are pre-up-projection
(proj_factor x) with a gated residual; sLSTM blocks post-project with a
gated FFN when ``d_ff`` is set.  All state math is float32.

Split over ``model``: the mLSTM by heads (``w_up`` column-parallel, its
output gathered over ``model`` as the input of each position's columns of
``wq``/``wk``/``wv`` and gates; each position scans its heads; the
output norm reads the gathered heads; ``w_down`` row-parallel).  Its decode
state is replicated, per the reference's cache layout: each position
updates its heads and the new state is gathered to every position.  The
sLSTM by units: ``w_in``'s columns are ``[z, i, f, o]`` blocks that do not
align with a split of the units, so each position reads it whole and takes
its units' columns; the recurrence reads every unit's ``h``, gathered over
``model`` at each step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    copy_to_model,
    gather_from_model,
    partial_product,
    reduce_from_model,
)
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import mlp, mlp_decls, rmsnorm, rmsnorm_decls
from repro_torch.sharding.blocks import ModelBlocks, model_group

_MLSTM_SPLIT = ("w_up", "w_gate", "wq", "wk", "wv", "w_down")
_W_IN_REASON = ("its columns are [z, i, f, o] blocks that do not align with a split of the "
                "sLSTM's units")

__all__ = [
    "mlstm_decls",
    "mlstm_apply",
    "mlstm_decode",
    "mlstm_init_state",
    "slstm_decls",
    "slstm_apply",
    "slstm_decode",
    "slstm_init_state",
]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    up = int(cfg.d_model * cfg.proj_factor)
    h = cfg.n_heads
    return up, h, up // h


def mlstm_decls(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    up, h, hd = _mlstm_dims(cfg)
    dt = cfg.dtype
    return {
        "norm": rmsnorm_decls(d),
        "w_up": ParamDecl((d, up), ("fsdp", "tensor"), dtype=dt),
        "w_gate": ParamDecl((d, up), ("fsdp", "tensor"), dtype=dt),
        "wq": ParamDecl((up, up), ("fsdp", "tensor"), dtype=dt),
        "wk": ParamDecl((up, up), ("fsdp", "tensor"), dtype=dt),
        "wv": ParamDecl((up, up), ("fsdp", "tensor"), dtype=dt),
        "w_if": ParamDecl((up, 2 * h), (None, None), dtype=torch.float32, scale=0.02),
        "b_if": ParamDecl((2 * h,), (None,), dtype=torch.float32, init="zeros"),
        "out_norm": rmsnorm_decls(up),
        "w_down": ParamDecl((up, d), ("tensor", "fsdp"), dtype=dt),
    }


def mlstm_init_state(batch: int, cfg: ModelConfig, device=None, heads=None
                     ) -> Dict[str, torch.Tensor]:
    _, h, hd = _mlstm_dims(cfg)
    h = h if heads is None else heads
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=torch.float32, device=device),
    }


def _mlstm_chunk_scan(
    q: torch.Tensor,   # [B, H, S, hd]   (already scaled)
    k: torch.Tensor,
    v: torch.Tensor,
    ig: torch.Tensor,  # [B, H, S] log input gate (pre-activation)
    lf: torch.Tensor,  # [B, H, S] log forget gate (logsigmoid(f_pre))
    state: Dict[str, torch.Tensor],
    chunk: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, h, s, hd = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s

    idx = torch.arange(chunk, device=q.device)
    tri = idx[:, None] >= idx[None, :]                        # causal within chunk
    neg_inf = torch.full((), float("-inf"), device=q.device)

    C, n, m = state["C"], state["n"], state["m"]              # [B,H,hd,hd],[B,H,hd],[B,H]
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb, igb, lfb = q[:, :, sl], k[:, :, sl], v[:, :, sl], ig[:, :, sl], lf[:, :, sl]
        bsum = torch.cumsum(lfb, dim=-1)                      # [B,H,L] inclusive
        btot = bsum[..., -1]                                  # [B,H]
        # log weight of source k contributing to target j (within chunk):
        #   a_{jk} = bsum_j - bsum_k + ig_k   (k <= j)
        a = bsum[..., :, None] - bsum[..., None, :] + igb[..., None, :]
        a = torch.where(tri[None, None], a, neg_inf)
        m_local = a.amax(dim=-1)                              # [B,H,L]
        m_j = torch.maximum(bsum + m[..., None], m_local)     # stabiliser per target
        d = torch.exp(a - m_j[..., None])                     # [B,H,L,L]
        g_inter = torch.exp(bsum + m[..., None] - m_j)        # [B,H,L]

        scores = torch.einsum("bhld,bhmd->bhlm", qb.float(), kb.float())
        intra = torch.einsum("bhlm,bhmd->bhld", scores * d, vb.float())
        inter = torch.einsum("bhld,bhde->bhle", qb.float(), C)
        num = inter * g_inter[..., None] + intra

        norm_inter = torch.einsum("bhld,bhd->bhl", qb.float(), n)
        # intra normaliser: sum_k d_{jk} (q_j . k_k)
        norm_intra = (scores * d).sum(dim=-1)
        denom = torch.maximum(torch.abs(norm_inter * g_inter + norm_intra), torch.exp(-m_j))
        outs.append((num / denom[..., None]).to(qb.dtype))

        # State update to chunk end.
        m_k = btot[..., None] - bsum + igb                    # [B,H,L]
        m_new = torch.maximum(btot + m, m_k.amax(dim=-1))
        w_old = torch.exp(btot + m - m_new)                   # [B,H]
        w_k = torch.exp(m_k - m_new[..., None])               # [B,H,L]
        kw = kb.float() * w_k[..., None]
        C = C * w_old[..., None, None] + torch.einsum("bhld,bhle->bhde", kw, vb.float())
        n = n * w_old[..., None] + kw.sum(dim=2)
        m = m_new

    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return out, {"C": C, "n": n, "m": m}


def _mlstm_qkv(p, xn: torch.Tensor, cfg: ModelConfig):
    up, h, hd = _mlstm_dims(cfg)
    u = xn @ p["w_up"]                                        # [B,S,up]
    return (u,) + _mlstm_heads(u, p["wq"], p["wk"], p["wv"], p["w_if"], p["b_if"], 0, h, cfg)


def _mlstm_heads(u, wq, wk, wv, w_if, b_if, first: int, n: int, cfg: ModelConfig):
    """(q, k, v, ig, lf) [B, n, S, ...] of heads ``first`` to ``first + n``
    (whose columns ``wq``/``wk``/``wv`` hold) from the whole ``u``."""
    _, h, hd = _mlstm_dims(cfg)
    bsz, s = u.shape[0], u.shape[1]
    q = (u @ wq).reshape(bsz, s, n, hd) * (hd ** -0.5)
    k = (u @ wk).reshape(bsz, s, n, hd) * (hd ** -0.5)
    v = (u @ wv).reshape(bsz, s, n, hd)
    if n == h:
        gates = u.float() @ w_if + b_if                       # [B,S,2H]
        ig, f_pre = gates[..., :h], gates[..., h:]
    else:
        sl = [slice(first, first + n), slice(h + first, h + first + n)]
        ig, f_pre = (u.float() @ w_if[:, c] + b_if[c] for c in sl)
    lf = F.logsigmoid(f_pre)

    def tr(x):                                                # -> [B,H,S,...]
        return x.transpose(1, 2)

    return tr(q), tr(k), tr(v), tr(ig), tr(lf)


def _mlstm_group(p, cfg: ModelConfig):
    """The model group of a split mLSTM (whole heads on each position)."""
    group = model_group(p, *_MLSTM_SPLIT)
    if group is not None and cfg.n_heads % group.size:
        for key in _MLSTM_SPLIT:
            p.note_gathered(key, f"{cfg.n_heads} mLSTM heads do not split over model "
                                 f"{group.size}")
        return None
    return group


def _mlstm_split(p, group, xn: torch.Tensor, cfg: ModelConfig):
    """(the normed input on each position, each position's (q, k, v, ig,
    lf) of its heads)."""
    _, h, _ = _mlstm_dims(cfg)
    n = h // group.size
    xs = copy_to_model(xn, group.devices)
    us = gather_from_model([xm @ w for xm, w in zip(xs, group.local("w_up"))], -1, group.devices)
    return xs, [_mlstm_heads(u, q.local("wq"), q.local("wk"), q.local("wv"), q.local("w_if"),
                             q.local("b_if"), i * n, n, cfg)
                for i, (q, u) in enumerate(zip(group.views, us))]


def _mlstm_out_split(p, group, x, xs, heads: List[torch.Tensor], cfg: ModelConfig):
    """``x`` plus the block's output from each position's heads' ``h``
    [B, S, up / M]: the heads gathered for the output norm, then each
    position's columns gated and row-parallel through ``w_down``."""
    up, _, _ = _mlstm_dims(cfg)
    n = up // group.size
    hs = rmsnorm(p["out_norm"], gather_from_model(heads, -1, [x.device])[0], cfg.norm_eps)
    ys = [partial_product(hm[..., i * n:(i + 1) * n] * F.silu(xm @ q.local("w_gate")),
                          q.local("w_down"))
          for i, (q, xm, hm) in enumerate(zip(group.views, xs, copy_to_model(hs, group.devices)))]
    return x + reduce_from_model(ys, x.device, x.dtype)


def mlstm_apply(p, x: torch.Tensor, cfg: ModelConfig, chunk: int = 64) -> torch.Tensor:
    """Full-sequence mLSTM block: [B, S, d] -> [B, S, d] (residual inside)."""
    up, h, hd = _mlstm_dims(cfg)
    b, s, d = x.shape
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    group = _mlstm_group(p, cfg)
    if group is None:
        u, q, k, v, ig, lf = _mlstm_qkv(p, xn, cfg)
        state = mlstm_init_state(b, cfg, x.device)
        hseq, _ = _mlstm_chunk_scan(q, k, v, ig, lf, state, chunk)
        hseq = hseq.transpose(1, 2).reshape(b, s, up)
        hseq = rmsnorm(p["out_norm"], hseq, cfg.norm_eps)
        gate = F.silu(xn @ p["w_gate"])
        return x + (hseq * gate) @ p["w_down"]
    xs, parts = _mlstm_split(p, group, xn, cfg)
    heads = []
    for q, k, v, ig, lf in parts:
        state = mlstm_init_state(b, cfg, q.device, heads=q.shape[1])
        hseq, _ = _mlstm_chunk_scan(q, k, v, ig, lf, state, chunk)
        heads.append(hseq.transpose(1, 2).reshape(b, s, -1))
    return _mlstm_out_split(p, group, x, xs, heads, cfg)


def _mlstm_step(q, k, v, ig, lf, C, n, m):
    """The one-step recurrence of heads ``[B, H, ...]``: (h [B, H, hd],
    C, n, m)."""
    q, k, v = (t[:, :, 0].float() for t in (q, k, v))        # [B,H,hd]
    ig, lf = ig[:, :, 0], lf[:, :, 0]                         # [B,H]
    m_new = torch.maximum(lf + m, ig)
    wf = torch.exp(lf + m - m_new)
    wi = torch.exp(ig - m_new)
    C_new = C * wf[..., None, None] + wi[..., None, None] * k[..., :, None] * v[..., None, :]
    n_new = n * wf[..., None] + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)), torch.exp(-m_new))
    return num / denom[..., None], C_new, n_new, m_new


def mlstm_decode(
    p, x: torch.Tensor, state: Dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict]:
    """One-token mLSTM step. x [B, 1, d] -> (y [B, 1, d], new state).  A
    state held by the positions along ``model`` (:class:`ModelBlocks`)
    runs split by heads."""
    up, h, hd = _mlstm_dims(cfg)
    b = x.shape[0]
    group = _mlstm_group(p, cfg)
    if isinstance(state["C"], ModelBlocks) and group is None:
        y, new = mlstm_decode(p, x, {k: v.whole(x.device) for k, v in state.items()}, cfg)
        return y, {k: state[k].like(v) for k, v in new.items()}
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    if group is None:
        u, q, k, v, ig, lf = _mlstm_qkv(p, xn, cfg)
        hvec, C_new, n_new, m_new = _mlstm_step(q, k, v, ig, lf, state["C"], state["n"],
                                                state["m"])
        hvec = hvec.reshape(b, 1, up).to(x.dtype)
        hvec = rmsnorm(p["out_norm"], hvec, cfg.norm_eps)
        gate = F.silu(xn @ p["w_gate"])
        y = x + (hvec * gate) @ p["w_down"]
        return y, {"C": C_new, "n": n_new, "m": m_new}
    xs, parts = _mlstm_split(p, group, xn, cfg)
    heads, new = [], {"C": [], "n": [], "m": []}
    for i, (q, k, v, ig, lf) in enumerate(parts):
        sl = slice(i * q.shape[1], (i + 1) * q.shape[1])
        hv, *st = _mlstm_step(q, k, v, ig, lf, *(state[key].blocks[i][:, sl]
                                                  for key in ("C", "n", "m")))
        heads.append(hv.reshape(b, 1, -1).to(x.dtype))
        for key, t in zip(("C", "n", "m"), st):
            new[key].append(t)
    state = {key: ModelBlocks(gather_from_model(ts, 1, group.devices), None)
             for key, ts in new.items()}
    return _mlstm_out_split(p, group, x, xs, heads, cfg), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_decls(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    dt = cfg.dtype
    decls = {
        "norm": rmsnorm_decls(d),
        # input projections for z, i, f, o (fused)
        "w_in": ParamDecl((d, 4 * d), ("fsdp", "tensor"), dtype=dt),
        # block-diagonal recurrence per head: [H, hd, 4*hd]
        "r_rec": ParamDecl(
            (cfg.n_heads, d // cfg.n_heads, 4 * (d // cfg.n_heads)),
            (None, None, None), dtype=torch.float32, scale=0.02,
        ),
        "b": ParamDecl((4 * d,), (None,), dtype=torch.float32, init="zeros"),
        "out_norm": rmsnorm_decls(d),
    }
    if cfg.d_ff:
        decls["ffn"] = mlp_decls(d, cfg.d_ff, dt)
        decls["ffn_norm"] = rmsnorm_decls(d)
    return decls


def slstm_init_state(batch: int, cfg: ModelConfig, device=None, units=None
                     ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model if units is None else units

    def zeros():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)

    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, d), -1e30, dtype=torch.float32, device=device)}


def _slstm_cell(r_rec, b, state, x_proj: torch.Tensor, h_all: torch.Tensor, cfg: ModelConfig,
                cols=None):
    """One sLSTM step of the units whose ``[z, i, f, o]`` columns ``cols``
    name (all by default).  x_proj [B, 4n] their input projection; h_all
    [B, d] every unit's ``h``."""
    d = cfg.d_model
    h_heads = h_all.reshape(-1, cfg.n_heads, d // cfg.n_heads)
    rec = torch.einsum("bhd,hde->bhe", h_heads, r_rec)        # [B,H,4hd]
    rec = rec.reshape(-1, 4 * d)
    if cols is not None:
        rec = rec[:, cols]
    pre = x_proj.float() + rec + b
    z, i_pre, f_pre, o = torch.split(pre, pre.shape[-1] // 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + state["m"], i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(lf + state["m"] - m_new)
    c_new = f * state["c"] + i * z
    n_new = f * state["n"] + i
    h_new = o * c_new / torch.clamp(torch.abs(n_new), min=1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_out(p, x: torch.Tensor, hseq: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = x + rmsnorm(p["out_norm"], hseq, cfg.norm_eps)
    if "ffn" in p:
        y = y + mlp(p["ffn"], rmsnorm(p["ffn_norm"], y, cfg.norm_eps))
    return y


def _slstm_group(p, cfg: ModelConfig):
    """The model group of a split sLSTM (``d_model`` units divide over it);
    ``w_in`` is recorded, every position reading it whole."""
    group = model_group(p, "w_in")
    if group is None:
        return None
    if cfg.d_model % group.size:
        p.note_gathered("w_in", f"{cfg.d_model} sLSTM units do not split over model "
                                f"{group.size}")
        return None
    return group


def _slstm_split(p, group, xn: torch.Tensor, cfg: ModelConfig):
    """Each position's (columns of its units, input projection of them,
    r_rec, bias)."""
    d = cfg.d_model
    n = d // group.size
    out = []
    for i, (q, xm) in enumerate(zip(group.views, copy_to_model(xn, group.devices))):
        cols = torch.cat([torch.arange(g * d + i * n, g * d + (i + 1) * n, device=q.device)
                          for g in range(4)])
        out.append((cols, xm @ q.whole("w_in", _W_IN_REASON)[:, cols], q.local("r_rec"),
                    q.local("b")[cols]))
    return out


def _slstm_steps(parts, states, xps_at, cfg: ModelConfig, devices):
    """One step of every position's units: the units' ``h`` gathered over
    ``model``, then each position's cell."""
    h_all = gather_from_model([st["h"] for st in states], -1, devices)
    return [_slstm_cell(r_rec, b, st, xp, ha, cfg, cols)
            for (cols, _, r_rec, b), st, xp, ha in zip(parts, states, xps_at, h_all)]


def slstm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence sLSTM block (sequential over time)."""
    b, s, d = x.shape
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    group = _slstm_group(p, cfg)
    if group is None:
        xp = xn @ p["w_in"]                                   # [B,S,4d]
        r_rec, bias = p["r_rec"], p["b"]
        st = slstm_init_state(b, cfg, x.device)
        hs = []
        for t in range(s):
            st = _slstm_cell(r_rec, bias, st, xp[:, t], st["h"], cfg)
            hs.append(st["h"])
        hseq = torch.stack(hs, dim=1).to(x.dtype)            # [B,S,d]
        return _slstm_out(p, x, hseq, cfg)
    parts = _slstm_split(p, group, xn, cfg)
    states = [slstm_init_state(b, cfg, dev, units=d // group.size) for dev in group.devices]
    hs = [[] for _ in parts]
    for t in range(s):
        states = _slstm_steps(parts, states, [xp[:, t] for _, xp, _, _ in parts], cfg,
                              group.devices)
        for h, st in zip(hs, states):
            h.append(st["h"])
    hseq = gather_from_model([torch.stack(h, dim=1) for h in hs], -1, [x.device])[0]
    return _slstm_out(p, x, hseq.to(x.dtype), cfg)


def slstm_decode(
    p, x: torch.Tensor, state: Dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict]:
    """One-token sLSTM step.  A state in blocks along ``model``
    (:class:`ModelBlocks`, units split) runs split."""
    group = _slstm_group(p, cfg)
    if isinstance(state["h"], ModelBlocks) and (group is None or state["h"].dim is None):
        y, new = slstm_decode(p, x, {k: v.whole(x.device) for k, v in state.items()}, cfg)
        return y, {k: state[k].like(v) for k, v in new.items()}
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    if group is None:
        xp = (xn @ p["w_in"])[:, 0]
        st = _slstm_cell(p["r_rec"], p["b"], state, xp, state["h"], cfg)
        return _slstm_out(p, x, st["h"][:, None].to(x.dtype), cfg), st
    parts = _slstm_split(p, group, xn, cfg)
    keys = ("c", "n", "h", "m")
    states = [{k: state[k].blocks[i] for k in keys} for i in range(group.size)]
    states = _slstm_steps(parts, states, [xp[:, 0] for _, xp, _, _ in parts], cfg,
                          group.devices)
    h = gather_from_model([st["h"] for st in states], -1, [x.device])[0]
    return (_slstm_out(p, x, h[:, None].to(x.dtype), cfg),
            {k: ModelBlocks([st[k] for st in states], 1) for k in keys})
