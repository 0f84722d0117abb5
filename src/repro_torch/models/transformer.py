"""Decoder-only LM assembler: the port's copy of ``repro/models/transformer.py``.

Every decoder-only family runs through ``cfg.block_pattern``: pure
attention (dense and MoE archs; pattern None is all 'attn'), xLSTM
('mlstm'/'slstm') and RecurrentGemma's hybrid ('rglru' + 'attn').  Layer
``i`` is of kind ``cfg.pattern_for_layer(i)``.  Latent-attention archs
(port-only) are all 'mla': DeepSeek-V3's block, a dense SwiGLU in the
leading ``first_k_dense`` layers and the sigmoid-routed dropless experts
after them (a block's parameters hold ``mlp`` or ``moe``); its decode
cache is the latent ``{c, k_r}`` (``models/mla.py``).  Kimi Linear
(port-only) lists its layers (``cfg.layer_kinds``): 'kda' blocks (Kimi
Delta Attention, ``models/kda.py``, then the same dense SwiGLU or
experts) beside 'mla' ones, so its decode cache holds two kinds of state
side by side: the latent ``{c, k_r}`` of its MLA layers and the
recurrent ``{S, conv}`` of its KDA layers, both written in place.  A mesh
takes neither yet.

Layers are an ``nn.ModuleList`` in layer order.  The reference stacks the
full cycles of the pattern under one ``lax.scan`` and runs the remainder
(the tail) unrolled; :func:`layer_split` gives that split, which
``convert.lm_params_from_arrays`` reads to carry the reference's stacked
weights across.  With ``remat`` each full cycle runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body) and the tail without.  Decode caches are per-layer lists on an
explicit device.  With a ``mesh`` (``forward``, ``lm_loss``,
``decode_step``) the same functions run over the batch's data shards in
lockstep, each shard reading the parameters from their blocks
(``sharding/blocks.py``).  Where the sharding profile splits ``tensor`` or
``expert`` dims over ``model`` (``tp``, ``serve_tp``), each block's split
layers run on every position of the shard, each on its own blocks, and
combine over ``model`` (the layers' modules); the rest of a block runs on
the shard's first position.  The decode cache is laid out as the
reference's ``cache_shardings`` lay it out (:func:`init_decode_cache`).

The parameter tree: ``{embed, layers: [block, ...], final_norm}``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import kda as kda_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.base import ParamDecl, drawn_as_stack
from repro_torch.models.layers import (
    embed_decls,
    embed_lookup,
    lm_logits,
    mlp,
    mlp_decls,
    rmsnorm,
    rmsnorm_decls,
    softcap,
    token_xent,
)
from repro_torch.sharding.blocks import (
    BlockStore,
    join_rows,
    lay_out_cache,
    shard_cache,
    shard_views,
    split_rows,
    store_shard_cache,
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

def _block_decls(kind: str, cfg: ModelConfig, layer: int = 0) -> Dict:
    if kind in ("mla", "kda"):
        d = {
            "attn_norm": rmsnorm_decls(cfg.d_model),
            "attn": (mla_mod.mla_decls if kind == "mla" else kda_mod.kda_decls)(cfg),
            "mlp_norm": rmsnorm_decls(cfg.d_model),
        }
        if cfg.is_moe_layer(layer):
            d["moe"] = moe_mod.moe_decls(cfg)
        else:
            d["mlp"] = mlp_decls(cfg.d_model, cfg.d_ff_dense, cfg.dtype)
        return d
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
    draw (:func:`_cycle_decls` over ``n_full``, from the stack's key); the
    tail's as declared.  With ``fan_in`` every layer draws as declared,
    with its own fan-in, from the same keys."""
    pattern, n_full, _ = layer_split(cfg)
    lp = len(pattern)
    n_cyc = 0 if fan_in else n_full * lp
    layers = []
    for i in range(cfg.n_layers):
        d = _block_decls(cfg.pattern_for_layer(i), cfg, i)
        if i < n_full * lp:
            d = drawn_as_stack(d, ("layers", "cyc", str(i % lp)), i // lp)
        else:
            d = drawn_as_stack(d, ("layers", "tail", str(i - n_full * lp)), None)
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


def _moe_input(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """An MoE block up to its experts: (x after attention, the experts'
    normed input)."""
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attn.attention_apply(p["attn"], h, cfg, positions, window=_attn_window(cfg))
    return x, rmsnorm(p["mlp_norm"], x, cfg.norm_eps)


def _block_apply(
    kind: str, p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, aux_loss or None)."""
    aux = None
    if kind == "attn" and cfg.is_moe:
        x, h = _moe_input(p, x, cfg, positions)
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg)
        x = x + y
    elif kind == "attn":
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        a = attn.attention_apply(p["attn"], h, cfg, positions, window=_attn_window(cfg))
        if cfg.use_parallel_block:
            # PaLM-style parallel attention+MLP: both branches read one norm.
            x = x + a + mlp(p["mlp"], h)
        else:
            x = x + a
            h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
            x = x + mlp(p["mlp"], h)
    elif kind in ("mla", "kda"):
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        x = x + (mla_mod.mla_apply(p["attn"], h, cfg, positions) if kind == "mla"
                 else kda_mod.kda_apply(p["attn"], h, cfg))
        x = x + _mla_mlp(p, rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
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


def _mla_mlp(p, h: torch.Tensor, cfg: ModelConfig, layer: Optional[int] = None,
             slots=None) -> torch.Tensor:
    """An 'mla' or 'kda' block's second half: its dense SwiGLU or its
    experts."""
    if "moe" in p:
        return moe_mod.dropless_apply(p["moe"], h, cfg, layer=layer, slots=slots)
    return mlp(p["mlp"], h)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, rematerialised in the backward when ``remat`` and
    autograd is recording (``jax.checkpoint``'s counterpart): only the
    arguments are kept, the activations inside are recomputed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _embed(params, tokens: Optional[torch.Tensor], frontend_embeds: Optional[torch.Tensor],
           cfg: ModelConfig) -> torch.Tensor:
    parts = []
    if frontend_embeds is not None:
        parts.append(frontend_embeds.to(cfg.dtype))
    if tokens is not None:
        parts.append(embed_lookup(params["embed"], tokens))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _default_positions(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    if cfg.mrope_sections is not None:
        positions = positions.expand(3, b, s)
    return positions


def _forward_shards(params: Sequence, xs: List[torch.Tensor], positions: Sequence,
                    cfg: ModelConfig, remat: bool):
    """The layers and the final norm over a batch split into row shards
    (one entry per shard: its parameters, its embedded rows, its
    positions), the shards in lockstep layer by layer.  Each layer runs on
    each shard alone, but for an MoE layer over several shards, whose
    routing groups and balance loss are those of the whole batch
    (``moe.moe_apply_shards``).  With ``remat`` each full cycle of the
    pattern, over all shards, is recomputed in the backward.  Returns (the
    shards' hidden states, the aux loss on the first shard's device)."""

    def run(first: int, last: int, aux, *xs):
        xs = list(xs)
        for i in range(first, last):
            kind = cfg.pattern_for_layer(i)
            ps = [p["layers"][i] for p in params]
            if len(xs) > 1 and kind == "attn" and cfg.is_moe:
                halves = [_moe_input(p, x, cfg, pos) for p, x, pos in zip(ps, xs, positions)]
                ys, a = moe_mod.moe_apply_shards([p["moe"] for p in ps],
                                                 [h for _, h in halves], cfg)
                xs = [x + y for (x, _), y in zip(halves, ys)]
                aux = aux + a
                continue
            for j, p in enumerate(ps):
                xs[j], a = _block_apply(kind, p, xs[j], cfg, positions[j])
                if a is not None:
                    aux = aux + a
        return (aux, *xs)

    pattern, n_full, _ = layer_split(cfg)
    lp = len(pattern)
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for c in range(n_full):
        aux, *xs = remat_call(remat, functools.partial(run, c * lp, (c + 1) * lp), aux, *xs)
    aux, *xs = run(n_full * lp, cfg.n_layers, aux, *xs)
    return [rmsnorm(p["final_norm"], x, cfg.norm_eps) for p, x in zip(params, xs)], aux


def _split_positions(positions, shards):
    """Positions [B, S] (or [3, B, S] for M-RoPE) split with the batch."""
    return split_rows(positions, shards, dim=positions.dim() - 2)


def forward(
    params,
    tokens: Optional[torch.Tensor],
    cfg: ModelConfig,
    *,
    mesh=None,
    positions: Optional[torch.Tensor] = None,
    frontend_embeds: Optional[torch.Tensor] = None,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (and/or frontend embeds) -> (hidden [B, S, d], aux loss).

    ``frontend_embeds`` [B, S_f, d] are prepended to the token embeddings
    (the stub modality frontends of the audio/VLM archs).  ``remat``
    recomputes each full cycle of the pattern in the backward.  With a
    ``mesh`` the same function runs over the batch's data shards
    (``sharding/blocks.py``: ``params`` a model, laid out on the mesh, or a
    ``BlockStore``); the hidden states come back joined on the mesh's
    first device."""
    if mesh is None:
        x = _embed(params, tokens, frontend_embeds, cfg)
        pos = _default_positions(x, cfg) if positions is None else positions
        xs, aux = _forward_shards([params], [x], [pos], cfg, remat)
        return xs[0], aux
    lead = tokens if tokens is not None else frontend_embeds
    views, shards = shard_views(params, cfg, mesh, lead.shape[0])
    xs = [_embed(v, t, f, cfg) for v, t, f in zip(
        views, _rows(tokens, shards), _rows(frontend_embeds, shards))]
    pos = ([_default_positions(x, cfg) for x in xs] if positions is None
           else _split_positions(positions, shards))
    xs, aux = _forward_shards(views, xs, pos, cfg, remat)
    return join_rows(xs, shards[0].device), aux


def _rows(x: Optional[torch.Tensor], shards) -> List[Optional[torch.Tensor]]:
    return [None] * len(shards) if x is None else split_rows(x, shards)


def _token_loss(params, hidden: torch.Tensor, aux: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, loss_chunk: int, remat: bool) -> torch.Tensor:
    # Align: predict token t+1 from hidden t over the *token* region only.
    off = hidden.shape[1] - tokens.shape[1]
    inputs = hidden[:, off:-1]
    targets = tokens[:, 1:].long()
    b, sm1, _ = inputs.shape
    chunk = min(loss_chunk, sm1)
    if sm1 % chunk:
        chunk = sm1
    embed = params["embed"]

    def body(h, t):
        return torch.sum(token_xent(embed, h, t, cfg, cfg.logit_softcap))

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, sm1, chunk):
        total = total + remat_call(remat, body, inputs[:, c0 : c0 + chunk],
                                   targets[:, c0 : c0 + chunk])
    return total / (b * sm1) + 0.01 * aux


def lm_shard_losses(
    params: Sequence,
    tokens: Sequence[torch.Tensor],
    cfg: ModelConfig,
    *,
    loss_chunk: int = 1024,
    frontend_embeds: Optional[Sequence] = None,
    remat: bool = True,
) -> List[torch.Tensor]:
    """:func:`lm_loss` of a batch split into row shards, one loss per shard
    (each argument a list with one entry per shard, on its device): shard
    ``i``'s next-token loss plus 0.01 times the balance loss of the whole
    batch, so the shards' mean is :func:`lm_loss` of the whole batch.  The
    meshed train step differentiates each shard's loss on its own."""
    fronts = [None] * len(tokens) if frontend_embeds is None else frontend_embeds
    xs = [_embed(p, t, f, cfg) for p, t, f in zip(params, tokens, fronts)]
    hs, aux = _forward_shards(params, xs, [_default_positions(x, cfg) for x in xs], cfg, remat)
    return [_token_loss(p, h, aux.to(h.device), t, cfg, loss_chunk, remat)
            for p, h, t in zip(params, hs, tokens)]


def lm_loss(
    params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    mesh=None,
    loss_chunk: int = 1024,
    frontend_embeds: Optional[torch.Tensor] = None,
    remat: bool = True,
) -> torch.Tensor:
    """Next-token cross entropy over the token region, float32.

    The logits are taken in sequence chunks of ``loss_chunk`` (the whole
    ``S - 1`` when it does not divide), each chunk's body recomputed in
    the backward under ``remat``, so at most one ``[B, chunk, vocab]``
    float32 block is alive.  Adds ``0.01`` times the MoE balance loss.
    With a ``mesh``, the mean of the data shards' losses
    (:func:`lm_shard_losses`) on the mesh's first device."""
    if mesh is None:
        return lm_shard_losses([params], [tokens], cfg, loss_chunk=loss_chunk,
                               frontend_embeds=[frontend_embeds], remat=remat)[0]
    views, shards = shard_views(params, cfg, mesh, tokens.shape[0])
    losses = lm_shard_losses(views, split_rows(tokens, shards), cfg, loss_chunk=loss_chunk,
                             frontend_embeds=_rows(frontend_embeds, shards), remat=remat)
    return sum(loss.to(shards[0].device) for loss in losses) / len(losses)


# ---------------------------------------------------------------------------
# Decode (single-token serve step)
# ---------------------------------------------------------------------------

def _block_cache(kind: str, batch: int, cfg: ModelConfig, max_seq: int, device):
    if kind == "mla":
        return mla_mod.init_latent_cache(batch, cfg, max_seq, device)
    if kind == "kda":
        return kda_mod.init_kda_cache(batch, cfg, device)
    if kind == "attn":
        return attn.init_kv_cache(batch, cfg, max_seq, 1, device)[0]
    if kind == "rglru":
        return rglru_mod.rglru_init_state(batch, cfg, device)
    if kind == "mlstm":
        return ssm_mod.mlstm_init_state(batch, cfg, device)
    if kind == "slstm":
        return ssm_mod.slstm_init_state(batch, cfg, device)
    raise ValueError(kind)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's block kind, in layer order."""
    return [cfg.pattern_for_layer(i) for i in range(cfg.n_layers)]


def dropless_layers(cfg: ModelConfig) -> List[int]:
    """The layers whose experts take the sigmoid router's dropless path
    (``moe.dropless_apply``), in layer order."""
    return [i for i, kind in enumerate(layer_kinds(cfg))
            if kind in ("mla", "kda") and cfg.is_moe_layer(i)]


def init_decode_cache(batch: int, cfg: ModelConfig, max_seq: int, device=None, *,
                      mesh=None):
    """One cache dict per layer: {k, v} for attention (a ring of the window
    for windowed archs), {c, k_r} for latent attention, {S, conv} for KDA,
    the recurrent state otherwise.  With a ``mesh``,
    laid out on it (``sharding.blocks.lay_out_cache``: ``k``/``v`` split by
    ``seq`` over ``model``, recurrent states by ``tensor``, the mLSTM state
    replicated, the batch over the data axes), made on ``device`` (the
    mesh's first by default) and copied to its blocks."""
    device = mesh.flat[0] if device is None and mesh is not None else device
    kinds = layer_kinds(cfg)
    cache = [_block_cache(kind, batch, cfg, max_seq, device) for kind in kinds]
    return cache if mesh is None else lay_out_cache(cache, kinds, mesh)


def _decode_attention(p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig):
    """A decode block's attention half: (x after attention, the MLP's
    normed input, the new cache)."""
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    y, nk, nv = attn.decode_attention(
        p["attn"], h, cache["k"], cache["v"], pos, cfg, window=_attn_window(cfg),
    )
    x = x + y
    return x, rmsnorm(p["mlp_norm"], x, cfg.norm_eps), {"k": nk, "v": nv}


def _block_decode(kind: str, p, x: torch.Tensor, cache, pos, cfg: ModelConfig,
                  layer: int = 0, terms=None, slots=None):
    if kind in ("mla", "kda"):
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        y, cache = (mla_mod.mla_decode(p["attn"], h, cache, pos, cfg, terms) if kind == "mla"
                    else kda_mod.kda_decode(p["attn"], h, cache, cfg))
        x = x + y
        return x + _mla_mlp(p, rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg, layer, slots), cache
    if kind == "attn":
        x, h, new = _decode_attention(p, x, cache, pos, cfg)
        if cfg.is_moe:
            y, _ = moe_mod.moe_apply(p["moe"], h, cfg)
            x = x + y
        else:
            x = x + mlp(p["mlp"], h)
        return x, new
    if kind == "rglru":
        x, st = rglru_mod.rglru_decode(p["rglru"], x, cache, cfg)
        h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        return x + mlp(p["mlp"], h, activation="gelu"), st
    if kind == "mlstm":
        return ssm_mod.mlstm_decode(p["mlstm"], x, cache, cfg)
    if kind == "slstm":
        return ssm_mod.slstm_decode(p["slstm"], x, cache, cfg)
    raise ValueError(kind)


def _decode_shards(params: Sequence, tokens: Sequence, caches: Sequence, pos,
                   cfg: ModelConfig, routing: Optional[Dict] = None):
    """One decode step over row shards in lockstep (as :func:`_forward_shards`):
    returns each shard's logits and new cache.  The latent-attention layers
    share the step's terms, made here once a shard."""
    xs = [embed_lookup(p["embed"], t) for p, t in zip(params, tokens)]
    new: List[List[Dict]] = [[] for _ in xs]
    kinds = layer_kinds(cfg)
    terms = ([mla_mod.step_terms(pos, c[kinds.index("mla")]["c"].shape[1], cfg, x.device)
              for c, x in zip(caches, xs)] if "mla" in kinds else [None] * len(xs))
    for i, kind in enumerate(kinds):
        ps = [p["layers"][i] for p in params]
        if len(xs) > 1 and kind == "attn" and cfg.is_moe:
            halves = [_decode_attention(p, x, c[i], pos, cfg)
                      for p, x, c in zip(ps, xs, caches)]
            ys, _ = moe_mod.moe_apply_shards([p["moe"] for p in ps],
                                             [h for _, h, _ in halves], cfg)
            for j, ((x, _, c), y) in enumerate(zip(halves, ys)):
                xs[j] = x + y
                new[j].append(c)
            continue
        for j, p in enumerate(ps):
            xs[j], c = _block_decode(kind, p, xs[j], caches[j][i], pos, cfg, i, terms[j],
                                     None if routing is None else routing.get(i))
            new[j].append(c)
    if cfg.router == "sigmoid" and routing is None:
        moe_mod.ROUTING.end_step()
    logits = []
    for p, x in zip(params, xs):
        x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
        logits.append(softcap(lm_logits(p["embed"], x[:, 0], cfg).float(), cfg.logit_softcap))
    return logits, new


def join_cache(store: BlockStore) -> List[Dict]:
    """A laid-out cache whole on its mesh's first device, one dict per
    layer."""
    return [{leaf: store.full(name) for leaf, name in node.items()} for node in store.tree]


def meshed_decode(run, params, tokens: torch.Tensor, caches: Sequence, kinds: Sequence,
                  cfg: ModelConfig, mesh):
    """One decode step over ``mesh``'s data shards: ``run(views, tokens,
    per-shard caches)`` -> (each shard's logits, each shard's new caches).
    Each of ``caches`` is laid out on the mesh (``lay_out_cache``) or, when
    given whole, laid out for the step and returned whole.  Returns (the
    logits joined on the mesh's first device, the caches)."""
    views, shards = shard_views(params, cfg, mesh, tokens.shape[0])
    stores = [c if isinstance(c, BlockStore) else lay_out_cache(c, k, mesh)
              for c, k in zip(caches, kinds)]
    logits, new = run(views, split_rows(tokens, shards),
                      [[shard_cache(st, s.pos) for st in stores] for s in shards])
    for s, per in zip(shards, new):
        for st, layers in zip(stores, per):
            store_shard_cache(st, s.pos, layers)
    out = [st if isinstance(c, BlockStore) else join_cache(st) for c, st in zip(caches, stores)]
    return join_rows(logits, shards[0].device), out


def decode_step(
    params,
    tokens: torch.Tensor,         # [B, 1] current token ids
    cache,
    pos,                          # current position: int, or 0-d int64 (see below)
    cfg: ModelConfig,
    *,
    mesh=None,
    routing: Optional[Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Any]:
    """One serve step: returns (logits [B, vocab] float32, new cache).
    Attention caches and KDA states are written in place; the other
    recurrent states are new.
    Attention, latent-attention and KDA layers without a mesh also take ``pos``
    as a 0-d int64 tensor on the card, never read back to the host: the
    form a CUDA graph of the step replays (``train/decode_graph.py``), which
    also gives ``routing``: each dropless layer's slots (``{layer: (ids [B,
    k], ends [E held])}``, ``moe.dropless_apply``), written in place of
    ``moe.ROUTING``'s record, whose step the graph's holder ends.  With
    a ``mesh`` the step runs over the batch's data shards, each on its
    blocks of the cache (one laid out by ``init_decode_cache(...,
    mesh=mesh)``, kept so; a whole cache is laid out for the step and
    returned whole); the logits come back joined on the mesh's first
    device."""
    if mesh is None:
        logits, new = _decode_shards([params], [tokens], [cache], pos, cfg, routing)
        return logits[0], new[0]

    def run(views, toks, per):
        logits, new = _decode_shards(views, toks, [c[0] for c in per], pos, cfg)
        return logits, [[n] for n in new]

    logits, (cache,) = meshed_decode(run, params, tokens, [cache], [layer_kinds(cfg)], cfg,
                                     mesh)
    return logits, cache
