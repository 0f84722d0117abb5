"""Decoder-only LM assembler: the port's copy of ``repro/models/transformer.py``.

Every decoder-only family runs through ``cfg.block_pattern``: pure
attention (dense and MoE archs; pattern None is all 'attn'), xLSTM
('mlstm'/'slstm') and RecurrentGemma's hybrid ('rglru' + 'attn').  Layer
``i`` is of kind ``cfg.pattern_for_layer(i)``.

Layers are an ``nn.ModuleList`` in layer order.  The reference stacks the
full cycles of the pattern under one ``lax.scan`` and runs the remainder
(the tail) unrolled; :func:`layer_split` gives that split, which
``convert.lm_params_from_arrays`` reads to carry the reference's stacked
weights across.  With ``remat`` each full cycle runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body) and the tail without.  Decode caches are per-layer lists on an
explicit device.

The parameter tree: ``{embed, layers: [block, ...], final_norm}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.base import ParamDecl
from repro_torch.models.layers import (
    embed_decls,
    embed_lookup,
    lm_logits,
    mlp,
    mlp_decls,
    rmsnorm,
    rmsnorm_decls,
    softcap,
    wide,
)

__all__ = [
    "model_decls",
    "forward",
    "lm_loss",
    "init_decode_cache",
    "decode_step",
    "layer_split",
]


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

def _block_decls(kind: str, cfg: ModelConfig) -> Dict:
    if kind == "attn":
        d = {
            "attn_norm": rmsnorm_decls(cfg.d_model),
            "attn": attn.attention_decls(cfg),
            "mlp_norm": rmsnorm_decls(cfg.d_model),
        }
        if cfg.is_moe:
            d["moe"] = moe_mod.moe_decls(cfg)
        else:
            d["mlp"] = mlp_decls(cfg.d_model, cfg.d_ff, cfg.dtype)
        return d
    if kind == "rglru":
        return {
            "rglru": rglru_mod.rglru_decls(cfg),
            "mlp_norm": rmsnorm_decls(cfg.d_model),
            "mlp": mlp_decls(cfg.d_model, cfg.d_ff, cfg.dtype),
        }
    if kind == "mlstm":
        return {"mlstm": ssm_mod.mlstm_decls(cfg)}
    if kind == "slstm":
        return {"slstm": ssm_mod.slstm_decls(cfg)}
    raise ValueError(f"unknown block kind {kind}")


def _cycle_decls(tree: Any, n: int) -> Any:
    """A block's declarations as the reference draws them in a stack of
    ``n``: there each parameter is one ``[n, ...]`` array whose fan-in is
    its first dim, ``n``, so a ``normal`` weight without a scale draws with
    std ``1/sqrt(n)`` (``_stack_decls`` and ``init_params``)."""
    if isinstance(tree, ParamDecl):
        if tree.init == "normal" and tree.scale is None:
            return dataclasses.replace(tree, scale=1.0 / math.sqrt(n))
        return tree
    return {k: _cycle_decls(v, n) for k, v in tree.items()}


def layer_split(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, n_full_cycles, tail_kinds): the reference's stacking."""
    pattern = cfg.block_pattern or ("attn",)
    lp = len(pattern)
    n_full = cfg.n_layers // lp
    tail = tuple(pattern[i] for i in range(cfg.n_layers - n_full * lp))
    return pattern, n_full, tail


def model_decls(cfg: ModelConfig, fan_in: bool = False) -> Dict:
    """Layers of the full cycles draw as the reference's stacked cycles
    draw (:func:`_cycle_decls` over ``n_full``); the tail's as declared.
    With ``fan_in`` every layer draws as declared, with its own fan-in."""
    pattern, n_full, _ = layer_split(cfg)
    n_cyc = 0 if fan_in else n_full * len(pattern)
    layers = []
    for i in range(cfg.n_layers):
        d = _block_decls(cfg.pattern_for_layer(i), cfg)
        layers.append(_cycle_decls(d, n_full) if i < n_cyc else d)
    return {
        "embed": embed_decls(cfg),
        "layers": layers,
        "final_norm": rmsnorm_decls(cfg.d_model),
    }


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _attn_window(cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window or cfg.local_window


def _block_apply(
    kind: str, p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, aux_loss or None)."""
    aux = None
    if kind == "attn":
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        a = attn.attention_apply(p["attn"], h, cfg, positions, window=_attn_window(cfg))
        if cfg.use_parallel_block and not cfg.is_moe:
            # PaLM-style parallel attention+MLP: both branches read one norm.
            x = x + a + mlp(p["mlp"], h)
        else:
            x = x + a
            h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
            if cfg.is_moe:
                y, aux = moe_mod.moe_apply(p["moe"], h, cfg)
                x = x + y
            else:
                x = x + mlp(p["mlp"], h)
    elif kind == "rglru":
        x = rglru_mod.rglru_apply(p["rglru"], x, cfg)
        h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h, activation="gelu")
    elif kind == "mlstm":
        x = ssm_mod.mlstm_apply(p["mlstm"], x, cfg)
    elif kind == "slstm":
        x = ssm_mod.slstm_apply(p["slstm"], x, cfg)
    else:
        raise ValueError(kind)
    return x, aux


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, rematerialised in the backward when ``remat`` and
    autograd is recording (``jax.checkpoint``'s counterpart): only the
    arguments are kept, the activations inside are recomputed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(
    params,
    tokens: Optional[torch.Tensor],
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    frontend_embeds: Optional[torch.Tensor] = None,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (and/or frontend embeds) -> (hidden [B, S, d], aux loss).

    ``frontend_embeds`` [B, S_f, d] are prepended to the token embeddings
    (the stub modality frontends of the audio/VLM archs).  ``remat``
    recomputes each full cycle of the pattern in the backward."""
    parts = []
    if frontend_embeds is not None:
        parts.append(frontend_embeds.to(cfg.dtype))
    if tokens is not None:
        parts.append(embed_lookup(params["embed"], tokens))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        if cfg.mrope_sections is not None:
            positions = positions.expand(3, b, s)

    layers = params["layers"]

    def run(x, aux, first: int, last: int):
        for i in range(first, last):
            x, a = _block_apply(cfg.pattern_for_layer(i), layers[i], x, cfg, positions)
            if a is not None:
                aux = aux + a
        return x, aux

    pattern, n_full, _ = layer_split(cfg)
    lp = len(pattern)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_full):
        x, aux_total = remat_call(remat, run, x, aux_total, c * lp, (c + 1) * lp)
    x, aux_total = run(x, aux_total, n_full * lp, cfg.n_layers)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux_total


def lm_loss(
    params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    loss_chunk: int = 1024,
    frontend_embeds: Optional[torch.Tensor] = None,
    remat: bool = True,
) -> torch.Tensor:
    """Next-token cross entropy over the token region, float32.

    The logits are taken in sequence chunks of ``loss_chunk`` (the whole
    ``S - 1`` when it does not divide), each chunk's body recomputed in
    the backward under ``remat``, so at most one ``[B, chunk, vocab]``
    float32 block is alive.  Adds ``0.01`` times the MoE balance loss."""
    hidden, aux = forward(params, tokens, cfg, frontend_embeds=frontend_embeds, remat=remat)
    # Align: predict token t+1 from hidden t over the *token* region only.
    off = hidden.shape[1] - tokens.shape[1]
    inputs = hidden[:, off:-1]
    targets = tokens[:, 1:].long()
    b, sm1, _ = inputs.shape
    chunk = min(loss_chunk, sm1)
    if sm1 % chunk:
        chunk = sm1
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["embed"]["head"]

    def body(h, t):
        logits = softcap(wide(h @ head), cfg.logit_softcap)
        tgt = logits.gather(-1, t[..., None])[..., 0]
        return torch.sum(torch.logsumexp(logits, dim=-1) - tgt)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, sm1, chunk):
        total = total + remat_call(remat, body, inputs[:, c0 : c0 + chunk],
                                   targets[:, c0 : c0 + chunk])
    return total / (b * sm1) + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (single-token serve step)
# ---------------------------------------------------------------------------

def _block_cache(kind: str, batch: int, cfg: ModelConfig, max_seq: int, device):
    if kind == "attn":
        return attn.init_kv_cache(batch, cfg, max_seq, 1, device)[0]
    if kind == "rglru":
        return rglru_mod.rglru_init_state(batch, cfg, device)
    if kind == "mlstm":
        return ssm_mod.mlstm_init_state(batch, cfg, device)
    if kind == "slstm":
        return ssm_mod.slstm_init_state(batch, cfg, device)
    raise ValueError(kind)


def init_decode_cache(batch: int, cfg: ModelConfig, max_seq: int, device=None) -> List[Dict]:
    """One cache dict per layer: {k, v} for attention (a ring of the window
    for windowed archs), the recurrent state otherwise."""
    return [_block_cache(cfg.pattern_for_layer(i), batch, cfg, max_seq, device)
            for i in range(cfg.n_layers)]


def _block_decode(kind: str, p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig):
    if kind == "attn":
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        y, nk, nv = attn.decode_attention(
            p["attn"], h, cache["k"], cache["v"], pos, cfg, window=_attn_window(cfg),
        )
        x = x + y
        h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        if cfg.is_moe:
            y, _ = moe_mod.moe_apply(p["moe"], h, cfg)
            x = x + y
        else:
            x = x + mlp(p["mlp"], h)
        return x, {"k": nk, "v": nv}
    if kind == "rglru":
        x, st = rglru_mod.rglru_decode(p["rglru"], x, cache, cfg)
        h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        return x + mlp(p["mlp"], h, activation="gelu"), st
    if kind == "mlstm":
        return ssm_mod.mlstm_decode(p["mlstm"], x, cache, cfg)
    if kind == "slstm":
        return ssm_mod.slstm_decode(p["slstm"], x, cache, cfg)
    raise ValueError(kind)


def decode_step(
    params,
    tokens: torch.Tensor,         # [B, 1] current token ids
    cache: List[Dict],
    pos: int,                     # current position
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, List[Dict]]:
    """One serve step: returns (logits [B, vocab] float32, new cache).
    Attention caches are written in place; recurrent states are new."""
    x = embed_lookup(params["embed"], tokens)
    new_cache = []
    for i, p in enumerate(params["layers"]):
        x, c = _block_decode(cfg.pattern_for_layer(i), p, x, cache[i], pos, cfg)
        new_cache.append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_logits(params["embed"], x[:, 0], cfg)
    return softcap(logits.float(), cfg.logit_softcap), new_cache
