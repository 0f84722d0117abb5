"""The plain reference of a dense decoder-only LM with grouped-query,
sliding-window attention (H2O-Danube-1.8B, arXiv:2401.16818; the Mistral
block), and the seeded weights that both it and the program read.

Float32 throughout, TF32 off, plain ``torch`` operations, no cache and no
batching tricks: every sequence runs whole through every layer, causally
masked, in blocks of sequences so that it fits.  It imports nothing of
the program.  Per layer (pre-norm residual):

  * RMSNorm ``x * rsqrt(mean(x^2) + eps) * scale``;
  * attention: ``q = h Wq``, ``k = h Wk``, ``v = h Wv`` split into heads of
    ``head_dim``; rotary embedding of q and k by position (the half
    rotation of Llama and Mistral: the first and second halves of a head
    are the pair, frequencies ``theta^(-2i/head_dim)``, angles in float64);
    query head ``j`` reads kv head ``j // (n_heads / n_kv_heads)``; scores
    ``q k^T / sqrt(head_dim)``, masked where the key is after the query or
    ``sliding_window`` or more positions before it; softmax; ``Wo``;
  * SwiGLU: ``(silu(h Wgate) * h Wup) Wdown``;

then a final RMSNorm and the untied head ``Wout``: logits over the
vocabulary at every position.  Departures from the paper: the weights are
random (nothing is trained), the norm has no bias (as published), and
the window never binds at the positions a cell holds when they are fewer
than ``sliding_window``.

Weights are one dict of tensors by the program's parameter names
(``embed.tok`` ``[V, d]``, ``layers.<i>.attn.wq`` ``[d, H * hd]``, ...,
``embed.head`` ``[d, V]``), each a matrix applied as ``x @ W``.
:func:`make_weights` draws them from a seed on the device, in the
configuration's dtype, in one call per scale: ``N(0, 1/fan_in)`` for the
matrices (chip_smoke's fan-in weights), ``N(0, 0.02^2)`` for the
embedding, ones for the norms (float32).
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["MATRICES", "fp8_e4m3", "leaves", "logits_blocks", "make_weights"]

#: A layer's matrices, by name under ``layers.<i>.``.
MATRICES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate", "mlp.w_up", "mlp.w_down")
_NORMS = ("attn_norm.scale", "mlp_norm.scale")
_EMBED_STD = 0.02
#: The largest finite float8 e4m3 value.
_E4M3_MAX = 448.0


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, std) of every weight; std None for a norm's ones."""
    if cfg.get("tie_embeddings"):
        raise ValueError("the reference holds an untied head only")
    d, h, kv, hd, ff, v = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                           cfg["d_ff"], cfg["vocab_size"])
    shapes = {"attn.wq": (d, h * hd), "attn.wk": (d, kv * hd), "attn.wv": (d, kv * hd),
              "attn.wo": (h * hd, d), "mlp.w_gate": (d, ff), "mlp.w_up": (d, ff),
              "mlp.w_down": (ff, d)}
    out = [("embed.tok", (v, d), _EMBED_STD), ("embed.head", (d, v), 1 / math.sqrt(d)),
           ("final_norm.scale", (d,), None)]
    for i in range(cfg["n_layers"]):
        out += [(f"layers.{i}.{k}", (d,), None) for k in _NORMS]
        out += [(f"layers.{i}.{k}", s, 1 / math.sqrt(s[0])) for k, s in shapes.items()]
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, views of one buffer per dtype: the matrices and
    the embedding in the configuration's dtype, drawn by one ``normal_``
    per scale from a generator on ``device`` seeded with ``seed``; the
    norms' scales ones in float32."""
    drawn = sorted((x for x in leaves(cfg) if x[2] is not None), key=lambda x: x[2])
    norms = [x for x in leaves(cfg) if x[2] is None]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for group, dtype in ((drawn, getattr(torch, cfg["dtype"])), (norms, torch.float32)):
        flat = torch.empty(sum(math.prod(shape) for _, shape, _ in group), dtype=dtype,
                           device=device)
        at = 0
        for std, same in itertools.groupby(group, key=lambda x: x[2]):
            n = sum(math.prod(shape) for _, shape, _ in same)
            if std is None:
                flat[at:at + n].fill_(1.0)
            else:
                flat[at:at + n].normal_(0.0, std, generator=gen)
            at += n
        at = 0
        for name, shape, _ in group:
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


def _rotary(s: int, hd: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) ``[s, hd/2]`` float32 of positions ``0..s-1``."""
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv
    return ang.sin().float().to(device), ang.cos().float().to(device)


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(h, w, cfg, sin, cos, mask):
    b, s, _ = h.shape
    nh, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = (h @ w["attn.wq"]).view(b, s, nh, hd).transpose(1, 2)
    k = (h @ w["attn.wk"]).view(b, s, kv, hd).transpose(1, 2)
    v = (h @ w["attn.wv"]).view(b, s, kv, hd).transpose(1, 2)
    q, k = _rotate(q, sin, cos), _rotate(k, sin, cos)
    k = k.repeat_interleave(nh // kv, dim=1)
    v = v.repeat_interleave(nh // kv, dim=1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return (att @ v).transpose(1, 2).reshape(b, s, nh * hd) @ w["attn.wo"]


def _mlp(h, w):
    return (F.silu(h @ w["mlp.w_gate"]) * (h @ w["mlp.w_up"])) @ w["mlp.w_down"]


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


@torch.no_grad()
def logits_blocks(weights: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor, *,
                  block: int = 32,
                  quantize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                  ) -> Iterator[Tuple[int, torch.Tensor]]:
    """The logits of ``tokens`` ``[N, S]`` (ids on the weights' device) at
    every position: yields (first row, float32 ``[b, S, V]``) for blocks
    of ``block`` sequences.  The layers run one at a time over all the
    sequences (each layer's weights made float32 once), ``block``
    sequences at a time.  ``quantize`` rounds every matrix and the
    embedding (the control).  TF32 is off while it computes and the
    process's settings hold again at each ``yield``, so a caller that
    interleaves other work between blocks runs it under its own."""
    eps, window = cfg["norm_eps"], cfg.get("sliding_window")

    def f32(name):
        t = weights[name].float()
        return quantize(t) if quantize is not None and not name.endswith(".scale") else t

    n, s = tokens.shape
    dev = tokens.device
    with _no_tf32():
        x = F.embedding(tokens.long(), f32("embed.tok"))
        sin, cos = _rotary(s, cfg["head_dim"], cfg["rope_theta"], dev)
        pos = torch.arange(s, device=dev)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[:, None] - pos[None, :] < window
        for i in range(cfg["n_layers"]):
            w = {k: f32(f"layers.{i}.{k}") for k in MATRICES + _NORMS}
            for r in range(0, n, block):
                h = x[r:r + block]
                h = h + _attention(_rmsnorm(h, w["attn_norm.scale"], eps), w, cfg, sin, cos,
                                   mask)
                x[r:r + block] = h + _mlp(_rmsnorm(h, w["mlp_norm.scale"], eps), w)
            del w
        norm, head = f32("final_norm.scale"), f32("embed.head")
    for r in range(0, n, block):
        with _no_tf32():
            out = _rmsnorm(x[r:r + block], norm, eps) @ head
        yield r, out
