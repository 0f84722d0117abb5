"""Encoder-decoder backbone (SeamlessM4T-large-v2's transformer core): the
port's copy of ``repro/models/encdec.py``.

The modality frontend (speech feature extractor) is a stub: callers pass
precomputed frame embeddings [B, S_enc, d] to the encoder.  The decoder is
a causal transformer with cross-attention; decode uses a self-attention
cache plus a cross-attention K/V cache computed once from the encoder's
output.  Layers are ``nn.ModuleList``s in layer order; caches are
per-layer lists.  With a ``mesh`` each function runs over the batch's
data shards (``sharding/blocks.py``), each shard on its own, its split
layers over ``model`` as the decoder-only blocks' (the loss
vocab-parallel; the self and cross caches laid out by ``seq``).  The
reference stacks each of ``enc`` and ``dec`` whole, and its layers draw as
its stacks draw (``transformer._cycle_decls``).

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
    token_xent,
)
from repro_torch.models.base import drawn_as_stack
from repro_torch.models.transformer import _cycle_decls, meshed_decode, remat_call
from repro_torch.sharding.blocks import join_rows, lay_out_cache, shard_views, split_rows

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

    def stacked(d, group, i, n):
        d = drawn_as_stack(d, (group,), i)
        return d if fan_in else _cycle_decls(d, n)

    return {
        "embed": embed_decls(cfg),
        "enc": [stacked(_enc_layer_decls(cfg), "enc", i, n_enc) for i in range(n_enc)],
        "enc_norm": rmsnorm_decls(cfg.d_model),
        "dec": [stacked(_dec_layer_decls(cfg), "dec", i, cfg.n_layers)
                for i in range(cfg.n_layers)],
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
    return torch.mean(token_xent(params["embed"], hidden[:, :-1], dec_tokens[:, 1:].long(),
                                 cfg, None))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def prepare_cross_cache(params, enc_out: torch.Tensor, cfg: ModelConfig, *, mesh=None):
    """Per-layer cross-attention K/V [B, KV, S_enc, hd] of the encoder output
    (the reference stacks them into [L, B, KV, S_enc, hd]); with a ``mesh``,
    laid out on it by ``seq``, as the self cache."""
    out = []
    for lp in params["dec"]:
        k, v = attn.cross_kv(lp["cross_attn"], enc_out, cfg)
        out.append({"k": k, "v": v})
    return out if mesh is None else lay_out_cache(out, ["attn"] * len(out), mesh)


def init_self_cache(batch: int, cfg: ModelConfig, max_seq: int, device=None, *, mesh=None):
    """The decoder's self-attention caches; with a ``mesh``, laid out on it
    by ``seq`` (made on ``device``, the mesh's first by default)."""
    device = mesh.flat[0] if device is None and mesh is not None else device
    cache = attn.init_kv_cache(batch, cfg, max_seq, cfg.n_layers, device)
    return cache if mesh is None else lay_out_cache(cache, ["attn"] * cfg.n_layers, mesh)


def _decode_one(params, tokens, self_cache, cross_cache, pos: int, cfg: ModelConfig):
    x = embed_lookup(params["embed"], tokens)
    new_self = []
    for lp, sc, xc in zip(params["dec"], self_cache, cross_cache):
        h = rmsnorm(lp["self_norm"], x, cfg.norm_eps)
        y, nk, nv = attn.decode_attention(lp["self_attn"], h, sc["k"], sc["v"], pos, cfg)
        x = x + y
        new_self.append({"k": nk, "v": nv})
        # Cross attention against the fixed encoder K/V.
        h = rmsnorm(lp["cross_norm"], x, cfg.norm_eps)
        x = x + attn.cross_decode_attention(lp["cross_attn"], h, xc["k"], xc["v"], cfg)
        h = rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + mlp(lp["mlp"], h)
    x = rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x[:, 0], cfg).float(), new_self


def encdec_decode_step(
    params,
    tokens: torch.Tensor,                  # [B, 1]
    self_cache,                            # per layer {k, v}: [B, KV, S_cache, hd]
    cross_cache,                           # per layer {k, v}: [B, KV, S_enc, hd]
    pos: int,
    cfg: ModelConfig,
    *,
    mesh=None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step -> (logits [B, vocab] float32, self cache).  The
    cross-attention has no mask and no soft-cap.  With a ``mesh``, over
    its data shards, each on its blocks of both caches (laid out on the
    mesh, or whole: then laid out for the step, the self cache returned
    whole); the logits come back joined on its first device."""
    if mesh is None:
        return _decode_one(params, tokens, self_cache, cross_cache, pos, cfg)

    def run(views, toks, per):
        outs = [_decode_one(v, t, sc, xc, pos, cfg) for v, t, (sc, xc) in zip(views, toks, per)]
        return [o[0] for o in outs], [[o[1], xc] for o, (_, xc) in zip(outs, per)]

    kinds = ["attn"] * cfg.n_layers
    logits, (self_cache, _) = meshed_decode(run, params, tokens, [self_cache, cross_cache],
                                            [kinds, kinds], cfg, mesh)
    return logits, self_cache
