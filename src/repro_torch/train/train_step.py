"""The LM train step: the port's copy of ``repro/train/train_step.py``.

Microbatched gradient accumulation, remat, optional int8 compression of
the gradients with error feedback, AdamW with float32 masters.  The
gradients are ``torch.autograd.grad`` of the loss with respect to the
model's parameters.  With ``microbatches > 1`` each microbatch's
gradients are added into float32 accumulators and divided by the count,
as the reference adds them; with one microbatch they keep the
parameters' dtype.  Sharding the step over a mesh is not here yet.

A train state is ``{"params": model, "opt": OptState}``, with
``"residual"`` (float32, keyed as the parameters) when the gradients are
compressed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed.collectives import compressed_grad_sync
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import adamw_update, global_norm, init_opt_state

__all__ = ["TrainState", "init_train_state", "make_loss_fn", "make_train_step"]


TrainState = Dict[str, Any]   # {"params", "opt", "residual"}


def make_loss_fn(cfg: ModelConfig, remat: bool = True) -> Callable:
    """(model, batch dict) -> float32 scalar loss.  Batch keys by family:
    decoder-only ``{tokens [B, S]}``, vision archs add ``{frontend_embeds
    [B, Sv, d]}``; encoder-decoders ``{frontend_embeds [B, Se, d],
    dec_tokens [B, Sd]}``."""

    def loss_fn(params, batch):
        if cfg.is_encoder_decoder:
            return ed.encdec_loss(params, batch["frontend_embeds"], batch["dec_tokens"], cfg,
                                  remat=remat)
        return tfm.lm_loss(params, batch["tokens"], cfg,
                           frontend_embeds=batch.get("frontend_embeds"), remat=remat)

    return loss_fn


def init_train_state(params, tcfg: TrainConfig) -> TrainState:
    """The train state of ``params`` (a model), whose parameters this turns
    gradients on for."""
    params.requires_grad_(True)
    state: TrainState = {"params": params, "opt": init_opt_state(params)}
    if tcfg.grad_compression:
        state["residual"] = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                             for n, p in params.named_parameters()}
    return state


def _split_microbatches(batch: Dict, k: int) -> Dict:
    """Each value reshaped to ``[k, B/k, ...]``: microbatch ``i`` is rows
    ``i*B/k`` to ``(i+1)*B/k - 1``."""
    def split(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by microbatches {k}")
        return x.reshape(k, b // k, *x.shape[1:])

    return {key: split(v) for key, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (state, metrics)``; metrics are float32
    device scalars ``loss``, ``grad_norm``, ``lr`` (and ``residual_norm``
    with compression).  The state's tensors are updated in place."""
    loss_fn = make_loss_fn(cfg, remat=tcfg.remat != "none")

    def value_and_grad(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss = loss_fn(params, batch)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state["params"]
        k = tcfg.microbatches
        if k > 1:
            mbs = _split_microbatches(batch, k)
            loss = torch.zeros((), dtype=torch.float32, device=state["opt"].step.device)
            grads = None
            for i in range(k):
                mb_loss, mb_grads = value_and_grad(params, {key: v[i] for key, v in mbs.items()})
                loss = loss + mb_loss
                if grads is None:       # 0 + g: the accumulators start as g in float32
                    grads = {n: g.to(torch.float32) for n, g in mb_grads.items()}
                else:
                    for n, g in mb_grads.items():
                        grads[n].add_(g.to(torch.float32))
                del mb_grads
            loss = loss / k
            for g in grads.values():
                g.div_(k)
        else:
            loss, grads = value_and_grad(params, batch)

        metrics = {"loss": loss}
        new_state: TrainState = {"params": params}
        if tcfg.grad_compression:
            grads, new_state["residual"] = compressed_grad_sync(grads, state["residual"])
            metrics["residual_norm"] = global_norm(new_state["residual"])
        params, new_state["opt"], opt_metrics = adamw_update(params, grads, state["opt"], tcfg)
        metrics.update(opt_metrics)
        return new_state, metrics

    return train_step
