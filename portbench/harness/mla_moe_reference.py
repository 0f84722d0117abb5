"""The plain reference of the DeepSeek-V3 decoder (Moonlight-16B-A3B;
arXiv:2412.19437, its latent attention from arXiv:2405.04434), and the
seeded weights that both it and the program read.

Float32 throughout, TF32 off, plain ``torch`` operations, no cache: every
sequence runs whole through every layer, causally masked.  It imports
nothing of the program.  The configuration is the model's own
``config.json`` keys.  Per layer (pre-norm residual, RMSNorm ``x *
rsqrt(mean(x^2) + eps) * scale``, ``eps`` ``rms_norm_eps``):

  * latent attention with no query low-rank: ``q = h Wq``, per head
    ``[q_nope, q_rope]`` (``qk_nope_head_dim``, ``qk_rope_head_dim``);
    ``[c, k_r] = h Wkv_a`` with ``c`` (``kv_lora_rank``) through its own
    RMSNorm (eps 1e-6, the norm's default in the published code); per head
    ``[k_nope, v] = c Wkv_b`` (``v_head_dim``); rotary embedding of
    ``q_rope`` and of the one ``k_r`` all heads share, over adjacent pairs
    ``(2i, 2i+1)`` (the published code's ``rope_interleave``, which
    permutes q and k alike: the same scores), frequencies
    ``rope_theta^(-2i/rope)``, angles in float64; scores ``[q_nope,
    q_rope] . [k_nope, k_r] / sqrt(nope + rope)``, causal softmax; ``Wo``;
  * layers before ``first_k_dense_replace``: a SwiGLU of
    ``intermediate_size``;
  * the others: ``s = sigmoid(h Wr)``; the ``num_experts_per_tok`` experts
    with the largest ``s + e_score_correction_bias`` (``n_group`` 1: no
    group step); weights ``s`` at those experts over their sum (+1e-20),
    times ``routed_scaling_factor``; each chosen expert's SwiGLU of
    ``moe_intermediate_size`` times its weight, summed; plus the shared
    experts as one ungated SwiGLU of ``n_shared_experts`` times that width;

then a final RMSNorm and the untied head ``Wout``.  Departures from the
published model: the weights are random (nothing is trained), and there
is no multi-token prediction module (Moonlight has none).

Computed layer by layer over all the sequences (each layer's weights made
float32 once), a block of sequences at a time, the routed experts
gathered per expert.  ``route``, where given, sees each MoE layer's
scores and may impose the experts (the routing-forced reference); the
weights are then its own scores at those experts.

Weights are one dict of tensors by the program's parameter names
(``embed.tok`` ``[V, d]``, ``layers.<i>.attn.wq`` ``[d, H * (nope +
rope)]``, ``layers.<i>.moe.w_gate`` ``[E, d, ff]``, ..., ``embed.head``
``[d, V]``), each a matrix applied as ``x @ W``.  :func:`make_weights`
draws them from a seed on the device in the configuration's dtype:
``N(0, 1/fan_in)`` for the matrices (the expert stacks by their ``d`` or
``ff``), ``N(0, 0.02^2)`` for the embedding, ``N(0, router_std^2)`` for
the router, ``N(0, bias_std^2)`` for the correction bias (float32), ones
for the norms (float32).
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["fp8_e4m3", "leaves", "logits_blocks", "make_weights"]

_EMBED_STD = 0.02
_LATENT_EPS = 1e-6
#: The largest finite float8 e4m3 value.
_E4M3_MAX = 448.0


def _dims(cfg: Dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], Optional[float], str]]:
    """(name, shape, std, kind) of every weight; kind ``matrix``,
    ``embed``, ``router``, ``bias`` (std from the configuration's
    ``assumed``) or ``norm`` (ones, std None)."""
    if cfg.get("tie_word_embeddings") or cfg.get("q_lora_rank"):
        raise ValueError("the reference holds an untied head and no query low-rank only")
    d, h, r, nope, rope, v = _dims(cfg)
    e, ff = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    ffs, dense, vocab = ff * cfg["n_shared_experts"], cfg["intermediate_size"], cfg["vocab_size"]
    a = cfg["assumed"]
    out = [("embed.tok", (vocab, d), _EMBED_STD, "embed"),
           ("embed.head", (d, vocab), 1 / math.sqrt(d), "matrix"),
           ("final_norm.scale", (d,), None, "norm")]
    for i in range(cfg["num_hidden_layers"]):
        at = f"layers.{i}."
        out += [(at + "attn_norm.scale", (d,), None, "norm"),
                (at + "mlp_norm.scale", (d,), None, "norm"),
                (at + "attn.kv_norm.scale", (r,), None, "norm")]
        mats = {"attn.wq": (d, h * (nope + rope)), "attn.wkv_a": (d, r + rope),
                "attn.wkv_b": (r, h * (nope + v)), "attn.wo": (h * v, d)}
        if i < cfg["first_k_dense_replace"]:
            mats.update({"mlp.w_gate": (d, dense), "mlp.w_up": (d, dense),
                         "mlp.w_down": (dense, d)})
        else:
            mats.update({"moe.w_gate": (e, d, ff), "moe.w_up": (e, d, ff),
                         "moe.w_down": (e, ff, d), "moe.shared_gate": (d, ffs),
                         "moe.shared_up": (d, ffs), "moe.shared_down": (ffs, d)})
            out += [(at + "moe.router", (d, e), a["router_std"], "router"),
                    (at + "moe.router_bias", (e,), a["bias_std"], "bias")]
        out += [(at + k, s, 1 / math.sqrt(s[-2]), "matrix") for k, s in mats.items()]
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, views of one buffer per dtype: the matrices and
    the embedding in the configuration's dtype, drawn by one ``normal_``
    per scale from a generator on ``device`` seeded with ``seed``; the
    router, its bias and the norms in float32."""
    wide = {"router", "bias", "norm"}
    groups = [([x for x in leaves(cfg) if x[3] not in wide], getattr(torch, cfg["torch_dtype"])),
              ([x for x in leaves(cfg) if x[3] in wide], torch.float32)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for group, dtype in groups:
        group = sorted(group, key=lambda x: (x[2] is None, x[2] or 0.0))
        flat = torch.empty(sum(math.prod(x[1]) for x in group), dtype=dtype, device=device)
        at = 0
        for std, same in itertools.groupby(group, key=lambda x: x[2]):
            n = sum(math.prod(x[1]) for x in same)
            if std is None:
                flat[at:at + n].fill_(1.0)
            else:
                flat[at:at + n].normal_(0.0, std, generator=gen)
            at += n
        at = 0
        for name, shape, _, _ in group:
            out[name] = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
    return out


def fp8_e4m3(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude to 448), back in ``w``'s dtype: the control's weights."""
    scale = w.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (w / scale).to(torch.float8_e4m3fn).to(w.dtype) * scale


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rotary(s: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) ``[s, dim/2]`` float32 of positions ``0..s-1``."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv
    return ang.sin().float().to(device), ang.cos().float().to(device)


def _rotate_pairs(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def _attention(h, w, cfg, sin, cos, mask):
    b, s, _ = h.shape
    _, nh, r, nope, rope, vd = _dims(cfg)
    q = (h @ w["attn.wq"]).view(b, s, nh, nope + rope).transpose(1, 2)
    kv = h @ w["attn.wkv_a"]
    c = _rmsnorm(kv[..., :r], w["attn.kv_norm.scale"], _LATENT_EPS)
    kvb = (c @ w["attn.wkv_b"]).view(b, s, nh, nope + vd).transpose(1, 2)
    q_rope = _rotate_pairs(q[..., nope:], sin, cos)
    k_rope = _rotate_pairs(kv[:, None, :, r:], sin, cos).expand(b, nh, s, rope)
    q = torch.cat([q[..., :nope], q_rope], dim=-1)
    k = torch.cat([kvb[..., :nope], k_rope], dim=-1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(nope + rope)
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return (att @ kvb[..., nope:]).transpose(1, 2).reshape(b, s, nh * vd) @ w["attn.wo"]


def _swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def _experts(h, w, cfg, layer: int, r0: int, route):
    """The routed and shared experts of the block ``h`` [b, s, d]."""
    b, s, d = h.shape
    k = cfg["num_experts_per_tok"]
    x = h.reshape(-1, d)
    scores = torch.sigmoid(x @ w["moe.router"])                           # [T, E]
    biased = scores + w["moe.router_bias"]
    ids = route(layer, r0, scores.view(b, s, -1), biased.view(b, s, -1)) if route else None
    ids = torch.topk(biased, k, dim=-1).indices if ids is None else ids.reshape(-1, k)
    wts = scores.gather(-1, ids)
    wts = (wts / (wts.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]).flatten()
    # Each expert's (token, slot) pairs, gathered by expert: one sort.
    order = torch.argsort(ids.flatten(), stable=True)
    counts = torch.bincount(ids.flatten(), minlength=cfg["n_routed_experts"]).tolist()
    pairs = torch.zeros((x.shape[0] * k, d), dtype=x.dtype, device=x.device)
    at = 0
    for e, n in enumerate(counts):
        if n:
            mine = order[at:at + n]
            y = _swiglu(x[mine // k], w["moe.w_gate"][e], w["moe.w_up"][e], w["moe.w_down"][e])
            pairs[mine] = y * wts[mine, None]
            at += n
    shared = _swiglu(x, w["moe.shared_gate"], w["moe.shared_up"], w["moe.shared_down"])
    return (pairs.view(-1, k, d).sum(1) + shared).view(b, s, d)


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the matrix products and cuDNN inside, the process's
    settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


RouteFn = Callable[[int, int, torch.Tensor, torch.Tensor], Optional[torch.Tensor]]


@torch.no_grad()
def logits_blocks(weights: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor, *,
                  block: int = 64, head_block: int = 8,
                  quantize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                  route: Optional[RouteFn] = None) -> Iterator[Tuple[int, torch.Tensor]]:
    """The logits of ``tokens`` ``[N, S]`` (ids on the weights' device) at
    every position: yields (first row, float32 ``[b, S, V]``) for blocks
    of ``head_block`` sequences.  The layers run one at a time over all the
    sequences (each layer's weights made float32 once), ``block`` sequences
    at a time.  ``quantize`` rounds every matrix, the router and the
    embedding (the control), not the norms or the bias.  ``route(layer,
    first row, scores, biased scores)`` (``[b, S, E]`` each) is called at
    each MoE layer of each block and may return the experts ``[b, S, k]``
    to use in place of the top-k.  TF32 is off while it computes and the
    process's settings hold again at each ``yield``."""
    eps = cfg["rms_norm_eps"]

    def f32(name):
        t = weights[name].float()
        plain = name.endswith((".scale", ".router_bias"))
        return quantize(t) if quantize is not None and not plain else t

    n, s = tokens.shape
    dev = tokens.device
    with _no_tf32():
        x = F.embedding(tokens.long(), f32("embed.tok"))
        sin, cos = _rotary(s, cfg["qk_rope_head_dim"], cfg["rope_theta"], dev)
        pos = torch.arange(s, device=dev)
        mask = pos[None, :] <= pos[:, None]
        for i in range(cfg["num_hidden_layers"]):
            at = f"layers.{i}."
            w = {k[len(at):]: f32(k) for k in weights if k.startswith(at)}
            for r0 in range(0, n, block):
                h = x[r0:r0 + block]
                h = h + _attention(_rmsnorm(h, w["attn_norm.scale"], eps), w, cfg, sin, cos, mask)
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
