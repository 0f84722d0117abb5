"""The decode step as one CUDA graph, replayed every step of ``generate``.

A decoder's step on the card is thousands of small operations (~2,150 for
h2o-danube-1.8b's 24 layers at batch 256, ~2,570 for Moonlight-16B-A3B's
27), and issuing them one by one from Python takes the host longer than
the card takes to run them.  Captured once and replayed, the step is one
launch: the host copies the step's tokens and position into static
buffers and replays, and runs ahead of the card.

:class:`DecodeGraph` holds what the graph reads and writes for one
``(params, cfg, batch, max_seq, device)``: the decode cache, a static
token buffer ``[B, 1]``, the position as a 0-d int64 tensor (which
``attention.decode_attention`` and ``mla.mla_decode`` take without reading
it back; the latent layers' angles and mask are made from it inside the
step), the graph and its logits.  A KDA layer's state and convolution
inputs (``kda.kda_decode``) are written in place by the step, the state
by ``csrc/kda_decode.cu``, so each replay carries them to the next.
Where the config has dropless expert layers it also holds their routing
slots, fixed for its life: the chosen experts ``[L_moe, B, k]`` and the
held experts' group ends ``[L_moe, E held]``, which each
such layer writes in the step in place of ``moe.ROUTING``'s record; after
each replay :meth:`DecodeGraph.step` hands them to ``ROUTING``
(``RoutingRecord.hand_over``: a copy only while it is armed), so the
recorder sees one entry per layer and step, as an eager step leaves it.
Its first step runs eagerly on a side stream, then captures
``transformer.decode_step`` on the static buffers, then replays; neither
the eager step nor the capture records routing.  That first step is the
holder's first, on a cache of zeros, and the eager step's writes are
zeroed again before the capture (a KDA state would otherwise take the
step twice), so the cache is as an eager step leaves it.  Each step returns a copy of
the logits, which stays valid after the next replay.

``generate`` holds one :class:`DecodeGraph` at a time (:func:`holder`):
a call with the same key reuses it, its cache zeroed first as a fresh
one starts; another key drops it before building the next.  The holder
keeps the parameters alive, since the graph reads them where they lie.

Which steps are graphed is decided from the input alone (:func:`graphed`):
a prompt on a CUDA device, no mesh, a decoder-only config without M-RoPE
or front-end embeddings whose layers are all ``'attn'``, ``'mla'`` or
``'kda'``, with experts, if any, on the sigmoid router's dropless path
(Moonlight, Kimi Linear).  The capacity-bounded experts (Qwen2-MoE,
Phi-3.5-MoE), the other recurrent kinds (whose states are new each step),
meshed and encoder-decoder steps and everything on the CPU run eagerly,
as before.

Each replay opens the span ``decode.replay``; its step opens none of the
layers' spans.  :data:`COUNTS` counts ``captures``, ``replays``, ``eager``
steps (``serve_step.decode``) and ``routing_copies``, the replays whose
routing was handed to a ``ROUTING`` that kept it.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import ROUTING
from repro_torch.spans import span

__all__ = ["COUNTS", "DecodeGraph", "drop", "graphed", "holder"]

#: Captures, replays, eager decode steps and routing copies since the
#: process started.
COUNTS: collections.Counter = collections.Counter()

_HELD: Optional["DecodeGraph"] = None


def graphed(cfg: ModelConfig, device, *, mesh=None, frontend_embeds=None) -> bool:
    """Whether ``generate`` runs this config's decode steps as a graph."""
    return (torch.device(device).type == "cuda" and mesh is None
            and not cfg.is_encoder_decoder and frontend_embeds is None
            and cfg.mrope_sections is None and (not cfg.is_moe or cfg.router == "sigmoid")
            and all(kind in ("attn", "mla", "kda") for kind in tfm.layer_kinds(cfg)))


class DecodeGraph:
    """One decode step of ``(params, cfg, batch, max_seq, device)``,
    captured on its first :meth:`step` and replayed on every later one."""

    def __init__(self, params, cfg: ModelConfig, batch: int, max_seq: int, device):
        self.params, self.cfg = params, cfg
        self.batch, self.max_seq, self.device = batch, max_seq, torch.device(device)
        self.cache = tfm.init_decode_cache(batch, cfg, max_seq, self.device)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=self.device)
        self.pos = torch.zeros((), dtype=torch.int64, device=self.device)
        self.dropless = tfm.dropless_layers(cfg)
        self.routing = None
        if self.dropless:
            n = len(self.dropless)
            self.route_ids = torch.zeros((n, batch, cfg.n_experts_per_token), dtype=torch.int64,
                                         device=self.device)
            self.route_ends = torch.zeros((n, cfg.experts_held), dtype=torch.int32,
                                          device=self.device)
            self.routing = {layer: (self.route_ids[i], self.route_ends[i])
                            for i, layer in enumerate(self.dropless)}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None

    def matches(self, params, cfg: ModelConfig, batch: int, max_seq: int, device) -> bool:
        return (params is self.params and cfg == self.cfg and batch == self.batch
                and max_seq == self.max_seq and torch.device(device) == self.device)

    def reset(self) -> None:
        """The cache back to zeros, as a fresh one starts."""
        for layer in self.cache:
            for leaf in layer.values():
                leaf.zero_()

    def _body(self) -> torch.Tensor:
        """The step on the static buffers: its logits."""
        return tfm.decode_step(self.params, self.tokens, self.cache, self.pos, self.cfg,
                               routing=self.routing)[0]

    def _capture(self) -> None:
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._body()
                self.reset()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.logits = self._body()
        self.graph = graph
        COUNTS["captures"] += 1

    def step(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """The logits [B, vocab] (float32, a copy) of ``tokens`` [B, 1] at
        ``pos``, the cache written in place, the routing handed over."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        if self.graph is None:
            self._capture()
        with span("decode.replay"):
            self.graph.replay()
        COUNTS["replays"] += 1
        if self.routing is not None and ROUTING.hand_over(self.dropless, self.route_ids,
                                                          self.route_ends):
            COUNTS["routing_copies"] += 1
        return self.logits.clone()


def holder(params, cfg: ModelConfig, batch: int, max_seq: int, device) -> DecodeGraph:
    """The held :class:`DecodeGraph` of this key with its cache zeroed, or
    a new one in place of the old."""
    global _HELD
    if _HELD is not None and _HELD.matches(params, cfg, batch, max_seq, device):
        _HELD.reset()
        return _HELD
    _HELD = None        # the old cache and graph pool go before the new ones are made
    _HELD = DecodeGraph(params, cfg, batch, max_seq, device)
    return _HELD


def drop() -> None:
    """Let go of the held graph, its cache and its parameters."""
    global _HELD
    _HELD = None
