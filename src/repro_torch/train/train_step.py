"""The LM train step: the port's copy of ``repro/train/train_step.py``.

Microbatched gradient accumulation, remat, optional int8 compression of
the gradients with error feedback, AdamW with float32 masters.  The
compression quantizes each gradient in the reference's layout: where the
reference stacks a group of layers into one ``[n, ...]`` leaf, the
group's gradients are joined in that order before their 2,048-element
blocks are cut (:func:`compress_grads`).  The
gradients are ``torch.autograd.grad`` of the loss with respect to the
model's parameters.  With ``microbatches > 1`` each microbatch's
gradients are added into float32 accumulators and divided by the count,
as the reference adds them; with one microbatch they keep the
parameters' dtype.

With a ``mesh`` (``make_train_step(cfg, tcfg, mesh)``) the step is the
same function of the global batch, run data-parallel over ZeRO-sharded
storage (``sharding/blocks.py``):

* storage: the parameters and their moments, masters and residual are
  :class:`BlockStore` s laid out by the parameters' specs
  (``launch.specs.param_shardings``); AdamW runs block by block on each
  block's device;
* compute: each microbatch (rows ``i*B/k`` to ``(i+1)*B/k - 1``) is split
  over the mesh's batch axes (``batch_shards``); each shard runs on its
  position's device, gathering each layer's parameters from their blocks
  inside the layer's remat region, and its gradients come back to the
  blocks it read through autograd;
* reduction: the shards' gradients are added in float32 in shard order,
  microbatch by microbatch, then divided by the number of shards, the
  order the unmeshed step adds its microbatches in; so a data-2 mesh at
  microbatches ``k`` computes the unmeshed step's sums at ``2 k``.  The
  norm for the clip is taken leaf by leaf over each whole gradient;
  compression runs on the reduced gradient, group by stacked group;
* tensor and expert parallelism (profiles ``tp``, ``serve_tp``): each
  position of a shard reads its own blocks of the leaves split over
  ``model``, so their gradients land in those blocks with no sum over
  ``model``; a leaf replicated over ``model`` that several positions read
  (a slice each) gets the positions' gradients summed into its holder,
  in position order, once.

A train state is ``{"params": model, "opt": OptState}``, with
``"residual"`` (float32, keyed as the parameters) when the gradients are
compressed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.convert import stacked_groups
from repro_torch.distributed.collectives import compressed_grad_sync
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tfm
from repro_torch.sharding.blocks import BlockStore, batch_shards, shard_params
from repro_torch.train.optimizer import (
    OptState,
    adamw_leaf,
    adamw_scalars,
    adamw_update,
    global_norm,
    init_opt_state,
)

__all__ = ["TrainState", "compress_grads", "gather_train_state", "init_train_state",
           "loss_and_grads", "make_loss_fn", "make_train_step", "shard_train_state"]


TrainState = Dict[str, Any]   # {"params", "opt", "residual"}


def make_loss_fn(cfg: ModelConfig, mesh=None, remat: bool = True) -> Callable:
    """(model, batch dict) -> float32 scalar loss.  Batch keys by family:
    decoder-only ``{tokens [B, S]}``, vision archs add ``{frontend_embeds
    [B, Sv, d]}``; encoder-decoders ``{frontend_embeds [B, Se, d],
    dec_tokens [B, Sd]}``.  With a ``mesh``, over its data shards."""

    def loss_fn(params, batch):
        if cfg.is_encoder_decoder:
            return ed.encdec_loss(params, batch["frontend_embeds"], batch["dec_tokens"], cfg,
                                  mesh=mesh, remat=remat)
        return tfm.lm_loss(params, batch["tokens"], cfg, mesh=mesh,
                           frontend_embeds=batch.get("frontend_embeds"), remat=remat)

    return loss_fn


def init_train_state(params, tcfg: TrainConfig) -> TrainState:
    """The train state of ``params``: a model, whose parameters this turns
    gradients on for, or a :class:`BlockStore` (a model laid out on a mesh
    by ``shard_params``), whose moments, masters and residual are laid out
    as it is."""
    if isinstance(params, BlockStore):
        def zeros(b):
            return torch.zeros(b.shape, dtype=torch.float32, device=b.device)

        state = {"params": params, "opt": OptState(
            step=torch.zeros((), dtype=torch.int32, device=params.home_device),
            m=params.like(zeros), v=params.like(zeros),
            master=params.like(lambda b: b.to(torch.float32, copy=True)))}
        if tcfg.grad_compression:
            state["residual"] = params.like(zeros)
        return state
    params.requires_grad_(True)
    state: TrainState = {"params": params, "opt": init_opt_state(params)}
    if tcfg.grad_compression:
        state["residual"] = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                             for n, p in params.named_parameters()}
    return state


def compress_grads(cfg: ModelConfig, grads: Dict[str, torch.Tensor],
                   residual: Dict[str, torch.Tensor], groups=None):
    """``compressed_grad_sync`` of gradients keyed by parameter name, each
    group of layers the reference stacks compressed as its one leaf:
    flattened and joined in stacking order, compressed, split back.
    ``groups`` (some of ``stacked_groups(cfg)``, all by default) names the
    groups ``grads`` holds.  Returns (gradients, new residual), keyed in
    the order given."""
    out_g: Dict[str, torch.Tensor] = {}
    out_r: Dict[str, torch.Tensor] = {}
    for names in stacked_groups(cfg) if groups is None else groups:
        g = torch.cat([grads[n].reshape(-1) for n in names])
        r = torch.cat([residual[n].reshape(-1) for n in names])
        dg, dr = compressed_grad_sync(g, r)
        start = 0
        for n in names:
            size = grads[n].numel()
            out_g[n] = dg[start:start + size].reshape(grads[n].shape)
            out_r[n] = dr[start:start + size].reshape(grads[n].shape)
            start += size
    return {n: out_g[n] for n in grads}, {n: out_r[n] for n in grads}


def _split_microbatches(batch: Dict, k: int) -> Dict:
    """Each value reshaped to ``[k, B/k, ...]``: microbatch ``i`` is rows
    ``i*B/k`` to ``(i+1)*B/k - 1``."""
    def split(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by microbatches {k}")
        return x.reshape(k, b // k, *x.shape[1:])

    return {key: split(v) for key, v in batch.items()}


def _grads(cfg: ModelConfig, tcfg: TrainConfig, params, batch: Dict):
    """The unmeshed step's loss and gradients by parameter name."""
    loss_fn = make_loss_fn(cfg, remat=tcfg.remat != "none")

    def value_and_grad(batch):
        names, leaves = zip(*params.named_parameters())
        loss = loss_fn(params, batch)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))

    k = tcfg.microbatches
    if k == 1:
        return value_and_grad(batch)
    mbs = _split_microbatches(batch, k)
    loss = torch.zeros((), dtype=torch.float32, device=next(params.parameters()).device)
    grads = None
    for i in range(k):
        mb_loss, mb_grads = value_and_grad({key: v[i] for key, v in mbs.items()})
        loss = loss + mb_loss
        if grads is None:       # 0 + g: the accumulators start as g in float32
            grads = {n: g.to(torch.float32) for n, g in mb_grads.items()}
        else:
            for n, g in mb_grads.items():
                grads[n].add_(g.to(torch.float32))
        del mb_grads
    for g in grads.values():
        g.div_(k)
    return loss / k, grads


def loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params, batch: Dict, mesh=None):
    """The train step's loss and its gradients before compression and the
    update: ``(loss, {name: gradient})``, accumulated over
    ``tcfg.microbatches`` as the step accumulates them.  ``params`` is a
    model (its gradients are turned on) or, with a ``mesh``, a model or a
    ``BlockStore`` laid out on it; then each gradient is reduced over the
    data shards and returned whole on the mesh's first device."""
    if mesh is None:
        return _grads(cfg, tcfg, params.requires_grad_(True), batch)
    store = shard_params(params, cfg, mesh)
    loss, grads, _ = _mesh_grads(cfg, tcfg, mesh, store, batch)
    return loss, {n: store.gather(n, store.positions[0], store.home_device, blocks=grads)
                  for n in store.names}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (state, metrics)``; metrics are float32
    device scalars ``loss``, ``grad_norm``, ``lr`` (and ``residual_norm``
    with compression).  The state's tensors are updated in place.  With a
    ``mesh`` the state is one laid out on it (:func:`shard_train_state`, or
    :func:`init_train_state` of ``shard_params``) and the metrics are on
    the mesh's first device."""
    if mesh is not None:
        return _mesh_train_step(cfg, tcfg, mesh)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state["params"]
        loss, grads = _grads(cfg, tcfg, params, batch)
        metrics = {"loss": loss}
        new_state: TrainState = {"params": params}
        if tcfg.grad_compression:
            grads, new_state["residual"] = compress_grads(cfg, grads, state["residual"])
            metrics["residual_norm"] = global_norm(new_state["residual"])
        params, new_state["opt"], opt_metrics = adamw_update(params, grads, state["opt"], tcfg)
        metrics.update(opt_metrics)
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The step over a mesh
# ---------------------------------------------------------------------------

def shard_train_state(state: TrainState, cfg: ModelConfig, mesh) -> TrainState:
    """An unmeshed train state laid out on ``mesh`` (copied): the parameters
    as :func:`shard_params` lays them out, their moments, masters and
    residual in the same blocks, the step on the mesh's first device."""
    store = shard_params(state["params"], cfg, mesh)

    def like(named):
        return BlockStore.from_tensors(named, store.specs, mesh, dtype=torch.float32,
                                       tree=store.tree)

    opt = state["opt"]
    out: TrainState = {"params": store, "opt": OptState(
        step=opt.step.to(store.home_device), m=like(opt.m), v=like(opt.v),
        master=like(opt.master))}
    if "residual" in state:
        out["residual"] = like(state["residual"])
    return out


def gather_train_state(state: TrainState) -> TrainState:
    """A meshed train state whole on its mesh's first device: parameters,
    moments, masters and residual as fresh name -> tensor maps (what
    ``convert.lm_state_to_arrays`` and the unmeshed step take)."""
    def whole(store: BlockStore):
        return {n: store.full(n).detach().clone() for n in store.names}

    opt = state["opt"]
    out: TrainState = {"params": whole(state["params"]), "opt": OptState(
        step=opt.step.clone(), m=whole(opt.m), v=whole(opt.v), master=whole(opt.master))}
    if "residual" in state:
        out["residual"] = whole(state["residual"])
    return out


def _mesh_shard_losses(cfg: ModelConfig, remat: bool, views, batches):
    if cfg.is_encoder_decoder:
        return [ed.encdec_loss(v, b["frontend_embeds"], b["dec_tokens"], cfg, remat=remat)
                for v, b in zip(views, batches)]
    return tfm.lm_shard_losses(views, [b["tokens"] for b in batches], cfg,
                               frontend_embeds=[b.get("frontend_embeds") for b in batches],
                               remat=remat)


def _mesh_grads(cfg: ModelConfig, tcfg: TrainConfig, mesh, store: BlockStore, batch: Dict):
    """The loss and the gradient of each block of ``store``, reduced over
    every shard of every microbatch, on the first position holding it
    (``grads[name][pos]``); and each position's holder (``canon``)."""
    remat = tcfg.remat != "none"
    k = tcfg.microbatches
    mbs = _split_microbatches(batch, k)
    shards = batch_shards(mesh, next(iter(mbs.values())).shape[1])
    n = k * len(shards)
    home = shards[0].device
    canon = {name: {pos: holders[store.index(name, pos)] for pos in store.positions}
             for name in store.names for holders in [store.holders(name)]}
    grads: Dict[str, Dict] = {name: {} for name in store.names}
    loss = None if n == 1 else torch.zeros((), dtype=torch.float32, device=home)
    for i in range(k):
        aliases = [store.aliases() for _ in shards]
        views = [store.view(s.pos, s.device, blocks=a) for s, a in zip(shards, aliases)]
        losses = _mesh_shard_losses(cfg, remat, views, [
            {key: v[i][s.rows].to(s.device) for key, v in mbs.items()} for s in shards])
        leaves = [(name, pos, t) for a in aliases for name, bl in a.items()
                  for pos, t in bl.items()]
        found = torch.autograd.grad(losses, [t for *_, t in leaves], allow_unused=True)
        del views, aliases
        for (name, pos, _), g in zip(leaves, found):   # shard-major: the fixed order
            if g is None:
                continue
            at = canon[name][pos]
            acc = grads[name].get(at)
            if n == 1:               # several positions of the shard read the block
                grads[name][at] = g if acc is None else (
                    acc.float() + g.to(device=acc.device, dtype=torch.float32)).to(acc.dtype)
            elif acc is None:        # 0 + g: the accumulator starts as g in float32
                grads[name][at] = g.to(device=store.blocks[name][at].device,
                                       dtype=torch.float32)
            else:
                acc.add_(g.to(device=acc.device, dtype=torch.float32))
        del leaves, found
        for ls in losses:
            loss = ls.detach().to(home) if n == 1 else loss + ls.detach().to(home)
    for name in store.names:
        for at in set(canon[name].values()):
            blk = store.blocks[name][at]
            if at not in grads[name]:
                grads[name][at] = torch.zeros(blk.shape, device=blk.device,
                                              dtype=blk.dtype if n == 1 else torch.float32)
            elif n > 1:
                grads[name][at].div_(n)
    return (loss if n == 1 else loss / n), grads, canon


def _mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        store: BlockStore = state["params"]
        home_pos = store.positions[0]
        home = store.home_device
        loss, grads, canon = _mesh_grads(cfg, tcfg, mesh, store, batch)

        def whole(name):
            return store.gather(name, home_pos, home, blocks=grads)

        metrics = {"loss": loss}
        new_state: TrainState = {"params": store}
        if tcfg.grad_compression:
            residual: BlockStore = state["residual"]
            for names in stacked_groups(cfg):
                dg, dr = compress_grads(cfg, {n: whole(n) for n in names},
                                        {n: residual.full(n) for n in names}, groups=[names])
                with torch.no_grad():
                    for n in names:
                        for at in grads[n]:
                            grads[n][at] = dg[n][store.slices(n, at)].to(grads[n][at].device)
                        for pos, blk in residual.blocks[n].items():
                            blk.copy_(dr[n][store.slices(n, pos)])
            new_state["residual"] = residual
            metrics["residual_norm"] = global_norm(residual.full(n) for n in store.names)
        opt = state["opt"]
        step = opt.step + 1
        gnorm = global_norm(whole(n) for n in store.names)
        scalars = adamw_scalars(step, gnorm, tcfg)
        on: Dict[torch.device, tuple] = {}
        for name in store.names:
            for pos, p in store.blocks[name].items():
                dev = p.device
                if dev not in on:
                    on[dev] = tuple(x.to(dev) for x in scalars)
                adamw_leaf(p, grads[name][canon[name][pos]].to(dev), opt.m.blocks[name][pos],
                           opt.v.blocks[name][pos], opt.master.blocks[name][pos], on[dev], tcfg)
        new_state["opt"] = dataclasses.replace(opt, step=step)
        metrics.update({"grad_norm": gnorm, "lr": scalars[1]})
        return new_state, metrics

    return train_step
