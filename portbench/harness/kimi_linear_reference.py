"""The plain reference of the Kimi Linear decoder (Kimi-Linear-48B-A3B;
arXiv:2510.26692), at a chip's share of its experts, and the seeded
weights that both it and the program read.

Float32 throughout, TF32 off, plain ``torch`` operations, no cache: every
sequence runs whole through every layer.  It imports nothing of the
program.  The configuration is the model's own ``config.json`` keys, with
``num_experts`` the experts held here (ids ``first_expert_held`` ..), and
``experts_routed`` the router's width (the published ``num_experts``).
Per layer (pre-norm residual, RMSNorm ``x * rsqrt(mean(x^2) + eps) *
scale``, ``eps`` ``rms_norm_eps``), its kind from
``linear_attn_config.full_attn_layers`` (1-based; the others are KDA):

  * Kimi Delta Attention (Sec. 3; ``linear_attn_config``: ``num_heads``
    heads of ``head_dim``, a short convolution of
    ``short_conv_kernel_size``): ``[q, k, v] = SiLU(conv(h W_qkv))``, the
    convolution causal and depthwise with no bias; ``q, k`` L2-normalised
    per head (eps 1e-6), ``q`` times ``head_dim^-1/2``; the log decay ``g =
    -exp(A_log) softplus(h W_f_a W_f_b + dt_bias)`` per key channel;
    ``beta = sigmoid(h W_beta)`` per head; then, a position at a time from
    a zero float32 state ``S`` [d_k, d_v] per head: ``S = S * exp(g)``,
    ``S += beta k (v - k^T S)^T``, ``o = S^T q``; the output ``W_o(RMSNorm(o)
    * sigmoid(h W_g_a W_g_b))``, the norm over each head's ``d_v`` with
    ``o_norm`` and ``rms_norm_eps``;
  * latent attention without a query low-rank and without rotary
    embedding (``mla_use_nope``): ``q = h Wq`` per head ``[q_nope,
    q_rope]``; ``[c, k_r] = h Wkv_a``, ``c`` through its own RMSNorm (eps
    1e-6); ``[k_nope, v] = c Wkv_b`` per head; scores ``[q_nope, q_rope] .
    [k_nope, k_r] / sqrt(nope + rope)`` with one ``k_r`` for all heads,
    causal softmax; ``Wo``;
  * layers before ``first_k_dense_replace``: a SwiGLU of
    ``intermediate_size``;
  * the others: ``s = sigmoid(h Wr)`` over all ``experts_routed``; the
    ``num_experts_per_token`` experts with the largest ``s +
    e_score_correction_bias`` (one group); weights ``s`` at those over
    their sum (+1e-20), times ``routed_scaling_factor``; the held experts'
    SwiGLUs of ``moe_intermediate_size`` times their weights, summed (what
    an absent expert would add is left out, as on the chip that holds
    these); plus the shared experts as one ungated SwiGLU;

then a final RMSNorm and the untied head.  Departures from the published
model: the weights are random, and only the held experts' part of each
expert layer is added.

Computed layer by layer over all the sequences, a block of sequences at a
time.  ``route``, where given, sees each MoE layer's scores and may
impose the experts (the routing-forced reference).

Weights are one dict of tensors by the program's parameter names
(``embed.tok`` ``[V, d]``, ``layers.<i>.attn.w_qkv`` ``[d, 3 H d_k]``,
``layers.<i>.attn.conv`` ``[W, 3 H d_k]``, ``layers.<i>.moe.w_gate``
``[held, d, ff]``, ...), each matrix applied as ``x @ W``.
:func:`make_weights` draws them from a seed on the device: the matrices
in the configuration's dtype ``N(0, 1/fan_in)`` (the conv taps by their
``W``), the embedding ``N(0, 0.02^2)``; in float32 the router ``N(0,
router_std^2)``, the correction bias ``N(0, bias_std^2)``, ``A_log`` the
log of ``U(1, 16)``, ``dt_bias`` the inverse softplus of a log-uniform
step in ``[dt_min, dt_max]``, the norms ones.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from harness.mla_moe_reference import _no_tf32, _rmsnorm, _swiglu, fp8_e4m3

__all__ = ["fp8_e4m3", "layer_kinds", "leaves", "logits_blocks", "make_weights"]

_EMBED_STD = 0.02
_LATENT_EPS = 1e-6
_L2_EPS = 1e-6
#: Kinds kept in float32 and never rounded by the control.
_WIDE = ("router", "bias", "norm", "a_log", "dt_bias")


def layer_kinds(cfg: Dict) -> List[str]:
    """``kda`` or ``mla`` of each layer, in order."""
    full = set(cfg["linear_attn_config"]["full_attn_layers"])
    return ["mla" if i + 1 in full else "kda" for i in range(cfg["num_hidden_layers"])]


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], Optional[float], str]]:
    """(name, shape, std, kind) of every weight; kind ``matrix``,
    ``embed``, ``router``, ``bias``, ``a_log``, ``dt_bias`` or ``norm``
    (std None where the draw is not a normal one)."""
    if cfg.get("tie_word_embeddings") or cfg.get("q_lora_rank"):
        raise ValueError("the reference holds an untied head and no query low-rank only")
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    lac = cfg["linear_attn_config"]
    hk, dk, w = lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]
    kd = hk * dk
    e, held, ff = cfg["experts_routed"], cfg["num_experts"], cfg["moe_intermediate_size"]
    ffs, dense, vocab = ff * cfg["num_shared_experts"], cfg["intermediate_size"], cfg["vocab_size"]
    a = cfg["assumed"]
    out = [("embed.tok", (vocab, d), _EMBED_STD, "embed"),
           ("embed.head", (d, vocab), 1 / math.sqrt(d), "matrix"),
           ("final_norm.scale", (d,), None, "norm")]
    for i, kind in enumerate(layer_kinds(cfg)):
        at = f"layers.{i}."
        out += [(at + "attn_norm.scale", (d,), None, "norm"),
                (at + "mlp_norm.scale", (d,), None, "norm")]
        if kind == "mla":
            out.append((at + "attn.kv_norm.scale", (r,), None, "norm"))
            mats = {"attn.wq": (d, h * (nope + rope)), "attn.wkv_a": (d, r + rope),
                    "attn.wkv_b": (r, h * (nope + v)), "attn.wo": (h * v, d)}
        else:
            out += [(at + "attn.o_norm.scale", (dk,), None, "norm"),
                    (at + "attn.a_log", (hk,), None, "a_log"),
                    (at + "attn.dt_bias", (kd,), None, "dt_bias")]
            mats = {"attn.w_qkv": (d, 3 * kd), "attn.conv": (w, 3 * kd),
                    "attn.w_f_a": (d, dk), "attn.w_f_b": (dk, kd), "attn.w_beta": (d, hk),
                    "attn.w_g_a": (d, dk), "attn.w_g_b": (dk, kd), "attn.wo": (kd, d)}
        if i < cfg["first_k_dense_replace"]:
            mats.update({"mlp.w_gate": (d, dense), "mlp.w_up": (d, dense),
                         "mlp.w_down": (dense, d)})
        else:
            mats.update({"moe.w_gate": (held, d, ff), "moe.w_up": (held, d, ff),
                         "moe.w_down": (held, ff, d), "moe.shared_gate": (d, ffs),
                         "moe.shared_up": (d, ffs), "moe.shared_down": (ffs, d)})
            out += [(at + "moe.router", (d, e), a["router_std"], "router"),
                    (at + "moe.router_bias", (e,), a["bias_std"], "bias")]
        out += [(at + k, s, 1 / math.sqrt(s[-2]), "matrix") for k, s in mats.items()]
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, each leaf drawn in :func:`leaves`' order from one
    generator on ``device`` seeded with ``seed``: the matrices and the
    embedding in the configuration's dtype, the rest in float32."""
    dtype, a = getattr(torch, cfg["torch_dtype"]), cfg["assumed"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, shape, std, kind in leaves(cfg):
        t = torch.empty(shape, dtype=torch.float32 if kind in _WIDE else dtype, device=device)
        if kind == "norm":
            t.fill_(1.0)
        elif kind == "a_log":
            t.uniform_(1.0, 16.0, generator=gen).log_()
        elif kind == "dt_bias":      # softplus^-1(dt) = dt + log(1 - exp(-dt))
            lo, hi = math.log(a["dt_min"]), math.log(a["dt_max"])
            dt = t.uniform_(lo, hi, generator=gen).exp_()
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            t.normal_(0.0, std, generator=gen)
        out[name] = t
    return out


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + _L2_EPS)


def _kda(h, w, cfg):
    """Kimi Delta Attention of the block ``h`` [b, s, d]: [b, s, d]."""
    b, s, _ = h.shape
    lac = cfg["linear_attn_config"]
    hk, dk, width = lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]
    pre = F.pad(h @ w["attn.w_qkv"], (0, 0, width - 1, 0))               # [b, W-1+s, 3K]
    mixed = sum(pre[:, j:j + s] * w["attn.conv"][j] for j in range(width))
    q, k, v = (t.reshape(b, s, hk, dk) for t in F.silu(mixed).chunk(3, dim=-1))
    q, k = _l2(q) * dk ** -0.5, _l2(k)
    f = (h @ w["attn.w_f_a"]) @ w["attn.w_f_b"] + w["attn.dt_bias"]
    g = -torch.exp(w["attn.a_log"])[:, None] * F.softplus(f).reshape(b, s, hk, dk)
    beta = torch.sigmoid(h @ w["attn.w_beta"])                             # [b, s, H]
    state = torch.zeros((b * hk, dk, dk), dtype=h.dtype, device=h.device)
    o = torch.empty((b, s, hk, dk), dtype=h.dtype, device=h.device)
    for t in range(s):
        kt = k[:, t].reshape(-1, 1, dk)
        state.mul_(torch.exp(g[:, t]).reshape(-1, dk, 1))
        u = torch.bmm(kt, state)                                           # k^T S [bH, 1, dv]
        upd = v[:, t].reshape(-1, 1, dk) - u
        state.baddbmm_((beta[:, t].reshape(-1, 1, 1) * kt).transpose(1, 2), upd)
        o[:, t] = torch.bmm(q[:, t].reshape(-1, 1, dk), state).view(b, hk, dk)
    gate = torch.sigmoid((h @ w["attn.w_g_a"]) @ w["attn.w_g_b"]).reshape(b, s, hk, dk)
    o = _rmsnorm(o, w["attn.o_norm.scale"], cfg["rms_norm_eps"]) * gate
    return o.reshape(b, s, hk * dk) @ w["attn.wo"]


def _mla(h, w, cfg, mask):
    """Latent attention without rotary embedding of the block ``h``."""
    b, s, _ = h.shape
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = (h @ w["attn.wq"]).view(b, s, nh, nope + rope).transpose(1, 2)
    kv = h @ w["attn.wkv_a"]
    c = _rmsnorm(kv[..., :r], w["attn.kv_norm.scale"], _LATENT_EPS)
    kvb = (c @ w["attn.wkv_b"]).view(b, s, nh, nope + vd).transpose(1, 2)
    k = torch.cat([kvb[..., :nope], kv[:, None, :, r:].expand(b, nh, s, rope)], dim=-1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(nope + rope)
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return (att @ kvb[..., nope:]).transpose(1, 2).reshape(b, s, nh * vd) @ w["attn.wo"]


def _experts(h, w, cfg, layer: int, r0: int, route):
    """The held experts' part and the shared experts of the block ``h``."""
    b, s, d = h.shape
    k, first = cfg["num_experts_per_token"], cfg["first_expert_held"]
    x = h.reshape(-1, d)
    scores = torch.sigmoid(x @ w["moe.router"])                            # [T, E routed]
    biased = scores + w["moe.router_bias"]
    ids = route(layer, r0, scores.view(b, s, -1), biased.view(b, s, -1)) if route else None
    ids = torch.topk(biased, k, dim=-1).indices if ids is None else ids.reshape(-1, k)
    wts = scores.gather(-1, ids)
    wts = (wts / (wts.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]).flatten()
    out = torch.zeros_like(x)
    flat = ids.flatten()
    for e in range(cfg["num_experts"]):
        mine = torch.nonzero(flat == first + e)[:, 0]
        if mine.numel():
            y = _swiglu(x[mine // k], w["moe.w_gate"][e], w["moe.w_up"][e], w["moe.w_down"][e])
            out.index_add_(0, mine // k, y * wts[mine, None])
    shared = _swiglu(x, w["moe.shared_gate"], w["moe.shared_up"], w["moe.shared_down"])
    return (out + shared).view(b, s, d)


RouteFn = Callable[[int, int, torch.Tensor, torch.Tensor], Optional[torch.Tensor]]


@torch.no_grad()
def logits_blocks(weights: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor, *,
                  block: int = 64, head_block: int = 8,
                  quantize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                  route: Optional[RouteFn] = None) -> Iterator[Tuple[int, torch.Tensor]]:
    """The logits of ``tokens`` ``[N, S]`` at every position: yields (first
    row, float32 ``[b, S, V]``) for blocks of ``head_block`` sequences.
    The layers run one at a time over all the sequences (each layer's
    weights made float32 once), ``block`` sequences at a time.
    ``quantize`` rounds every matrix, the router and the embedding (the
    control), not the norms, the bias, ``A_log`` or ``dt_bias``.  ``route(layer,
    first row, scores, biased scores)`` (``[b, S, E routed]`` each) is
    called at each MoE layer of each block and may return the experts
    ``[b, S, k]`` to use in place of the top-k.  TF32 is off while it
    computes and the process's settings hold again at each ``yield``."""
    eps = cfg["rms_norm_eps"]
    plain = tuple(f".{n}" for n in ("scale", "router_bias", "a_log", "dt_bias"))

    def f32(name):
        t = weights[name].float()
        return quantize(t) if quantize is not None and not name.endswith(plain) else t

    n, s = tokens.shape
    dev = tokens.device
    with _no_tf32():
        x = F.embedding(tokens.long(), f32("embed.tok"))
        pos = torch.arange(s, device=dev)
        mask = pos[None, :] <= pos[:, None]
        for i, kind in enumerate(layer_kinds(cfg)):
            at = f"layers.{i}."
            w = {k[len(at):]: f32(k) for k in weights if k.startswith(at)}
            for r0 in range(0, n, block):
                h = x[r0:r0 + block]
                a = _rmsnorm(h, w["attn_norm.scale"], eps)
                h = h + (_kda(a, w, cfg) if kind == "kda" else _mla(a, w, cfg, mask))
                m = _rmsnorm(h, w["mlp_norm.scale"], eps)
                if i < cfg["first_k_dense_replace"]:
                    h = h + _swiglu(m, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"])
                else:
                    h = h + _experts(m, w, cfg, i, r0, route)
                x[r0:r0 + block] = h
            del w
        norm, head = f32("final_norm.scale"), f32("embed.head")
    for r0 in range(0, n, head_block):
        with _no_tf32():
            out = _rmsnorm(x[r0:r0 + head_block], norm, eps) @ head
        yield r0, out
