"""Encoder-decoder backbone (SeamlessM4T-large-v2's transformer core): the
port's copy of ``repro/models/encdec.py``.

The modality frontend (speech feature extractor) is a stub: callers pass
precomputed frame embeddings [B, S_enc, d] to the encoder.  The decoder is
a causal transformer with cross-attention; decode uses a self-attention
cache plus a cross-attention K/V cache computed once from the encoder's
output.  Layers are ``nn.ModuleList``s in layer order; caches are
per-layer lists.  With a ``mesh`` each function runs over the batch's
data shards (``sharding/blocks.py``), each shard on its own.  The reference stacks each of ``enc`` and ``dec`` whole,
and its layers draw as its stacks draw (``transformer._cycle_decls``).

The parameter tree: ``{embed, enc: [layer, ...], enc_norm, dec: [layer,
...], dec_norm}``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_decls,
    embed_lookup,
    lm_logits,
    mlp,
    mlp_decls,
    rmsnorm,
    rmsnorm_decls,
    wide,
)
from repro_torch.models.transformer import _cycle_decls, join_cache, remat_call, split_cache
from repro_torch.sharding.blocks import join_rows, shard_views, split_rows

__all__ = [
    "encdec_decls",
    "encdec_forward",
    "encdec_loss",
    "encode",
    "prepare_cross_cache",
    "init_self_cache",
    "encdec_decode_step",
]


def _enc_layer_decls(cfg: ModelConfig) -> Dict:
    return {
        "attn_norm": rmsnorm_decls(cfg.d_model),
        "attn": attn.attention_decls(cfg),
        "mlp_norm": rmsnorm_decls(cfg.d_model),
        "mlp": mlp_decls(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def _dec_layer_decls(cfg: ModelConfig) -> Dict:
    return {
        "self_norm": rmsnorm_decls(cfg.d_model),
        "self_attn": attn.attention_decls(cfg),
        "cross_norm": rmsnorm_decls(cfg.d_model),
        "cross_attn": attn.attention_decls(cfg, cross=True),
        "mlp_norm": rmsnorm_decls(cfg.d_model),
        "mlp": mlp_decls(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def encdec_decls(cfg: ModelConfig, fan_in: bool = False) -> Dict:
    """Each layer draws as the reference's stack of its group draws, or
    with ``fan_in`` as declared, with its own fan-in."""
    n_enc = cfg.n_encoder_layers or cfg.n_layers

    def stacked(d, n):
        return d if fan_in else _cycle_decls(d, n)

    return {
        "embed": embed_decls(cfg),
        "enc": [stacked(_enc_layer_decls(cfg), n_enc) for _ in range(n_enc)],
        "enc_norm": rmsnorm_decls(cfg.d_model),
        "dec": [stacked(_dec_layer_decls(cfg), cfg.n_layers) for _ in range(cfg.n_layers)],
        "dec_norm": rmsnorm_decls(cfg.d_model),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _over_shards(fn, params, cfg: ModelConfig, mesh, *batch: torch.Tensor):
    """``fn(view, *rows)`` on each data shard of ``mesh`` (the encoder-
    decoder has no cross-row coupling, so each shard runs alone); returns
    the shards' results."""
    views, shards = shard_views(params, cfg, mesh, batch[0].shape[0])
    rows = [split_rows(x, shards) for x in batch]
    return [fn(v, *r) for v, *r in zip(views, *rows)], shards


def encode(params, frontend_embeds: torch.Tensor, cfg: ModelConfig, *, mesh=None,
           remat: bool = True) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings [B, S_enc, d];
    ``remat`` recomputes each layer in the backward.  With a ``mesh``, over
    its data shards, joined on its first device."""
    if mesh is not None:
        outs, shards = _over_shards(lambda v, f: encode(v, f, cfg, remat=remat),
                                    params, cfg, mesh, frontend_embeds)
        return join_rows(outs, shards[0].device)
    x = frontend_embeds.to(cfg.dtype)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def body(x, lp):
        h = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        x = x + attn.attention_apply(lp["attn"], h, cfg, positions, causal=False)
        h = rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        return x + mlp(lp["mlp"], h)

    for lp in params["enc"]:
        x = remat_call(remat, body, x, lp)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def encdec_forward(
    params, frontend_embeds: torch.Tensor, dec_tokens: torch.Tensor, cfg: ModelConfig, *,
    mesh=None, remat: bool = True,
) -> torch.Tensor:
    """Returns decoder hidden states [B, S_dec, d]; ``remat`` recomputes
    each encoder and decoder layer in the backward.  With a ``mesh``, over
    its data shards, joined on its first device."""
    if mesh is not None:
        outs, shards = _over_shards(lambda v, f, t: encdec_forward(v, f, t, cfg, remat=remat),
                                    params, cfg, mesh, frontend_embeds, dec_tokens)
        return join_rows(outs, shards[0].device)
    enc_out = encode(params, frontend_embeds, cfg, remat=remat)
    x = embed_lookup(params["embed"], dec_tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def body(x, lp):
        h = rmsnorm(lp["self_norm"], x, cfg.norm_eps)
        x = x + attn.attention_apply(lp["self_attn"], h, cfg, positions, causal=True)
        h = rmsnorm(lp["cross_norm"], x, cfg.norm_eps)
        x = x + attn.attention_apply(lp["cross_attn"], h, cfg, positions, kv_source=enc_out)
        h = rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        return x + mlp(lp["mlp"], h)

    for lp in params["dec"]:
        x = remat_call(remat, body, x, lp)
    return rmsnorm(params["dec_norm"], x, cfg.norm_eps)


def encdec_loss(
    params, frontend_embeds: torch.Tensor, dec_tokens: torch.Tensor, cfg: ModelConfig, *,
    mesh=None, remat: bool = True,
) -> torch.Tensor:
    """Mean next-token cross entropy of the decoder, float32 (unchunked).
    With a ``mesh``, the mean of its data shards' losses."""
    if mesh is not None:
        losses, shards = _over_shards(lambda v, f, t: encdec_loss(v, f, t, cfg, remat=remat),
                                      params, cfg, mesh, frontend_embeds, dec_tokens)
        return sum(loss.to(shards[0].device) for loss in losses) / len(losses)
    hidden = encdec_forward(params, frontend_embeds, dec_tokens, cfg, remat=remat)
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["embed"]["head"]
    logits = wide(hidden[:, :-1] @ head)
    tgt = logits.gather(-1, dec_tokens[:, 1:].long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - tgt)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def prepare_cross_cache(params, enc_out: torch.Tensor, cfg: ModelConfig
                        ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer cross-attention K/V [B, KV, S_enc, hd] of the encoder output
    (the reference stacks them into [L, B, KV, S_enc, hd])."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    b, s, _ = enc_out.shape
    out = []
    for lp in params["dec"]:
        k = (enc_out @ lp["cross_attn"]["wk"]).reshape(b, s, kv, hd)
        v = (enc_out @ lp["cross_attn"]["wv"]).reshape(b, s, kv, hd)
        out.append({"k": k.transpose(1, 2), "v": v.transpose(1, 2)})
    return out


def init_self_cache(batch: int, cfg: ModelConfig, max_seq: int, device=None
                    ) -> List[Dict[str, torch.Tensor]]:
    return attn.init_kv_cache(batch, cfg, max_seq, cfg.n_layers, device)


def encdec_decode_step(
    params,
    tokens: torch.Tensor,                  # [B, 1]
    self_cache: List[Dict],                # per layer {k, v}: [B, KV, S_cache, hd]
    cross_cache: List[Dict],               # per layer {k, v}: [B, KV, S_enc, hd]
    pos: int,
    cfg: ModelConfig,
    *,
    mesh=None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step -> (logits [B, vocab] float32, self cache).  The
    cross-attention has no mask and no soft-cap.  With a ``mesh``, over
    its data shards, each on its rows of both caches; logits and self
    cache come back joined on its first device."""
    if mesh is not None:
        views, shards = shard_views(params, cfg, mesh, tokens.shape[0])
        outs = [encdec_decode_step(v, t, sc, xc, pos, cfg) for v, t, sc, xc in zip(
            views, split_rows(tokens, shards), split_cache(self_cache, shards),
            split_cache(cross_cache, shards))]
        home = shards[0].device
        return join_rows([o[0] for o in outs], home), join_cache([o[1] for o in outs], home)
    x = embed_lookup(params["embed"], tokens)
    h_heads, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    g = h_heads // kvh
    new_self = []
    for lp, sc, xc in zip(params["dec"], self_cache, cross_cache):
        h = rmsnorm(lp["self_norm"], x, cfg.norm_eps)
        y, nk, nv = attn.decode_attention(lp["self_attn"], h, sc["k"], sc["v"], pos, cfg)
        x = x + y
        new_self.append({"k": nk, "v": nv})
        # Cross attention against the fixed encoder K/V.
        h = rmsnorm(lp["cross_norm"], x, cfg.norm_eps)
        q = (h @ lp["cross_attn"]["wq"]).reshape(b, 1, h_heads, hd)
        qg = q.transpose(1, 2).reshape(b, kvh, g, 1, hd)
        bias = torch.zeros((1, xc["k"].shape[2]), dtype=torch.float32, device=x.device)
        o = attn._sdpa(qg, xc["k"], xc["v"], bias)
        o = o.reshape(b, h_heads, 1, hd).transpose(1, 2).reshape(b, 1, h_heads * hd)
        x = x + o @ lp["cross_attn"]["wo"]
        h = rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + mlp(lp["mlp"], h)
    x = rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    logits = lm_logits(params["embed"], x[:, 0], cfg).float()
    return logits, new_self
