"""Serving steps: the port's copy of ``repro/train/serve_step.py``.

``prefill``: the full-sequence forward, giving last-position logits.
``decode``: one token against the cache (attention caches written in
place, recurrent states replaced).  ``sample_tokens``: greedy or
temperature sampling with latched EOS; a sequence whose EOS has latched
emits pad tokens, the saturation early exit the ASIC's CSRF applies to
clause evaluation, applied to batched decoding.  ``make_tm_serve_fn``:
the ConvCoTM classify step closed over a frozen servable.

``prefill``, ``decode`` and ``make_serve_fns`` take a ``mesh``, as the
reference's do.  Greedy decoding matches the reference token for token
(both argmaxes take the first maximum).  Temperature sampling is
``jax.random.categorical`` of a key (``core/prng.py``), so from one key it
emits the reference's tokens wherever its Gumbel noise's last-place
rounding does not decide the argmax.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import lm_logits, softcap

__all__ = [
    "prefill",
    "decode",
    "sample_tokens",
    "make_serve_fns",
    "make_tm_serve_fn",
]


@torch.no_grad()
def prefill(params, batch: Dict, cfg: ModelConfig, *, mesh=None) -> torch.Tensor:
    """Returns last-position logits [B, vocab] (float32).  With a ``mesh``
    the forward runs over its data shards, the logits on its first device."""
    if cfg.is_encoder_decoder:
        hidden = ed.encdec_forward(params, batch["frontend_embeds"], batch["dec_tokens"], cfg,
                                   mesh=mesh)
    else:
        hidden, _ = tfm.forward(params, batch.get("tokens"), cfg, mesh=mesh,
                                frontend_embeds=batch.get("frontend_embeds"))
    logits = lm_logits(params["embed"], hidden[:, -1], cfg).float()
    return softcap(logits, cfg.logit_softcap)


@torch.no_grad()
def decode(
    params,
    tokens: torch.Tensor,
    cache: List[Dict],
    pos: int,
    cfg: ModelConfig,
    *,
    cross_cache: Optional[List[Dict]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step -> (logits [B, vocab], new cache); with a ``mesh``,
    over its data shards."""
    if cfg.is_encoder_decoder:
        return ed.encdec_decode_step(params, tokens, cache, cross_cache, pos, cfg, mesh=mesh)
    return tfm.decode_step(params, tokens, cache, pos, cfg, mesh=mesh)


@torch.no_grad()
def sample_tokens(
    key: Optional[torch.Tensor],
    logits: torch.Tensor,
    *,
    temperature: float = 0.0,
    eos_id: int = 2,
    done: Optional[torch.Tensor] = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy/temperature sampling with latched EOS masking.

    Returns (tokens [B] int32, done [B]); once done latches, the sequence
    emits ``pad_id``.  Temperature sampling is
    ``categorical(key, logits / temperature)`` in the logits' dtype, drawn
    on the key's device (the logits' device); greedy needs no key."""
    if temperature > 0.0:
        nxt = prng.categorical(key.to(logits.device), logits / temperature, axis=-1)
    else:
        nxt = torch.argmax(logits, dim=-1)
    nxt = nxt.to(torch.int32)
    if done is None:
        done = torch.zeros(nxt.shape, dtype=torch.bool, device=nxt.device)
    nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
    done = done | (nxt == eos_id)
    return nxt, done


def make_tm_serve_fn(servable, path: Optional[str] = None):
    """The ConvCoTM classify step closed over a frozen servable: the
    ``make_serve_fns`` of the TM archs.  The returned function maps
    literals (in the path's input form) to the engine's packed result,
    int32 ``[B, 1 + m]`` (predictions, class sums).  Prefer
    :class:`repro_torch.serve.ServingEngine` for batched traffic: this is
    the engine's own single step."""
    from repro_torch.serve.engine import classify_step
    from repro_torch.serve.paths import get_path

    name = path or servable.config.eval_path
    get_path(name)  # fail fast on unknown paths
    return functools.partial(classify_step, servable, path_name=name)


def make_serve_fns(cfg: ModelConfig, mesh=None):
    """(prefill_fn, decode_fn) closed over ``cfg`` and ``mesh``."""

    def prefill_fn(params, batch):
        return prefill(params, batch, cfg, mesh=mesh)

    def decode_fn(params, tokens, cache, pos, cross_cache=None):
        return decode(params, tokens, cache, pos, cfg, cross_cache=cross_cache, mesh=mesh)

    return prefill_fn, decode_fn
