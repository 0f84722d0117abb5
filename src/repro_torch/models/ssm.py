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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import mlp, mlp_decls, rmsnorm, rmsnorm_decls

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


def mlstm_init_state(batch: int, cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    _, h, hd = _mlstm_dims(cfg)
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
    bsz, s = xn.shape[0], xn.shape[1]
    u = xn @ p["w_up"]                                        # [B,S,up]
    q = (u @ p["wq"]).reshape(bsz, s, h, hd) * (hd ** -0.5)
    k = (u @ p["wk"]).reshape(bsz, s, h, hd) * (hd ** -0.5)
    v = (u @ p["wv"]).reshape(bsz, s, h, hd)
    gates = u.float() @ p["w_if"] + p["b_if"]                 # [B,S,2H]
    ig = gates[..., :h]
    lf = F.logsigmoid(gates[..., h:])

    def tr(x):                                                # -> [B,H,S,...]
        return x.transpose(1, 2)

    return u, tr(q), tr(k), tr(v), tr(ig), tr(lf)


def mlstm_apply(p, x: torch.Tensor, cfg: ModelConfig, chunk: int = 64) -> torch.Tensor:
    """Full-sequence mLSTM block: [B, S, d] -> [B, S, d] (residual inside)."""
    up, h, hd = _mlstm_dims(cfg)
    b, s, d = x.shape
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    u, q, k, v, ig, lf = _mlstm_qkv(p, xn, cfg)
    state = mlstm_init_state(b, cfg, x.device)
    hseq, _ = _mlstm_chunk_scan(q, k, v, ig, lf, state, chunk)
    hseq = hseq.transpose(1, 2).reshape(b, s, up)
    hseq = rmsnorm(p["out_norm"], hseq, cfg.norm_eps)
    gate = F.silu(xn @ p["w_gate"])
    return x + (hseq * gate) @ p["w_down"]


def mlstm_decode(
    p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token mLSTM step. x [B, 1, d] -> (y [B, 1, d], new state)."""
    up, h, hd = _mlstm_dims(cfg)
    b = x.shape[0]
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    u, q, k, v, ig, lf = _mlstm_qkv(p, xn, cfg)
    q, k, v = (t[:, :, 0].float() for t in (q, k, v))        # [B,H,hd]
    ig, lf = ig[:, :, 0], lf[:, :, 0]                         # [B,H]

    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, ig)
    wf = torch.exp(lf + m - m_new)
    wi = torch.exp(ig - m_new)
    C_new = C * wf[..., None, None] + wi[..., None, None] * k[..., :, None] * v[..., None, :]
    n_new = n * wf[..., None] + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)), torch.exp(-m_new))
    hvec = (num / denom[..., None]).reshape(b, 1, up).to(x.dtype)
    hvec = rmsnorm(p["out_norm"], hvec, cfg.norm_eps)
    gate = F.silu(xn @ p["w_gate"])
    y = x + (hvec * gate) @ p["w_down"]
    return y, {"C": C_new, "n": n_new, "m": m_new}


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


def slstm_init_state(batch: int, cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model

    def zeros():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)

    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, d), -1e30, dtype=torch.float32, device=device)}


def _slstm_cell(p, state, x_proj: torch.Tensor, cfg: ModelConfig):
    """One sLSTM step. x_proj [B, 4d] precomputed input projection."""
    d = cfg.d_model
    h_heads = state["h"].reshape(-1, cfg.n_heads, d // cfg.n_heads)
    rec = torch.einsum("bhd,hde->bhe", h_heads, p["r_rec"])  # [B,H,4hd]
    rec = rec.reshape(-1, 4 * d)
    pre = x_proj.float() + rec + p["b"]
    z, i_pre, f_pre, o = torch.split(pre, d, dim=-1)
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


def slstm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence sLSTM block (sequential over time)."""
    b, s, d = x.shape
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    xp = xn @ p["w_in"]                                       # [B,S,4d]
    st = slstm_init_state(b, cfg, x.device)
    hs = []
    for t in range(s):
        st = _slstm_cell(p, st, xp[:, t], cfg)
        hs.append(st["h"])
    hseq = torch.stack(hs, dim=1).to(x.dtype)                # [B,S,d]
    return _slstm_out(p, x, hseq, cfg)


def slstm_decode(
    p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    xp = (xn @ p["w_in"])[:, 0]
    st = _slstm_cell(p, state, xp, cfg)
    return _slstm_out(p, x, st["h"][:, None].to(x.dtype), cfg), st
