"""Input specs and shardings for every (arch x shape) cell: the port's copy
of ``repro/launch/specs.py``.

The abstract stand-ins are tensors on the ``meta`` device (shapes and
dtypes, no memory: a 42 B-parameter model's train state is described,
never made), beside the matching :class:`NamedSharding`s of
``sharding/partition.py``.  The trees follow the port's layouts: the
train state is keyed by parameter name, as ``init_train_state`` keys it,
and a decode cache is a list per layer, as ``init_decode_cache`` makes
it; where the reference stacks a group of layers along a leading axis,
the port's per-layer spec is the reference's without its leading
``None``.

Cell kinds:
  train   -> the train step  (state + batch)
  prefill -> ``prefill``     (params + full-sequence batch)
  decode  -> ``decode``      (params + token + cache + pos)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tfm
from repro_torch.models.base import ParamTree, abstract_params, pspec_tree
from repro_torch.sharding.partition import (
    NamedSharding,
    mesh_axis_size,
    sharding_for,
)
from repro_torch.sharding.partition import spec as logical_spec

__all__ = [
    "abstract_model",
    "abstract_train_state",
    "batch_shardings",
    "batch_specs",
    "cache_leaf_axes",
    "cache_shardings",
    "cache_specs",
    "microbatches_for",
    "model_decls",
    "opt_state_like",
    "param_logical_axes",
    "param_shardings",
    "state_shardings",
]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def model_decls(cfg: ModelConfig, fan_in: bool = False) -> Dict:
    """The declaration tree of ``cfg``.  Its layers draw as the reference's
    stacked layers draw; with ``fan_in``, each layer with its own fan-in
    (std ``1/sqrt(d_in)``), the well-scaled weights the gradient checks
    are held on."""
    if cfg.is_encoder_decoder:
        return ed.encdec_decls(cfg, fan_in)
    return tfm.model_decls(cfg, fan_in)


def abstract_model(cfg: ModelConfig) -> ParamTree:
    return abstract_params(model_decls(cfg))


def _by_name(cfg: ModelConfig, tree) -> Dict[str, Any]:
    """The leaves of a tree shaped as ``model_decls(cfg)``, keyed by their
    ``named_parameters()`` names."""
    out = {}
    for name, _ in abstract_model(cfg).named_parameters():
        node = tree
        for k in name.split("."):
            node = node[int(k)] if isinstance(node, list) else node[k]
        out[name] = node
    return out


def param_shardings(cfg: ModelConfig, mesh) -> Dict[str, NamedSharding]:
    """Each parameter's sharding on ``mesh`` (``pspec_tree``), keyed by its
    ``named_parameters()`` name."""
    return {n: NamedSharding(mesh, s)
            for n, s in _by_name(cfg, pspec_tree(model_decls(cfg), mesh)).items()}


def param_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Each parameter's declared logical axes, keyed by its name."""
    return {n: d.axes for n, d in _by_name(cfg, model_decls(cfg)).items()}


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def _frontend_split(cfg: ModelConfig, seq: int) -> Tuple[int, int]:
    """(frontend_len, token_len) for modality archs."""
    f = int(seq * cfg.frontend_fraction)
    return f, seq - f


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Full-sequence batch (train and prefill cells)."""
    gb, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        # The encoder sees the full assigned sequence; the decoder's text is
        # shorter (the speech-to-text ratio).
        return {
            "frontend_embeds": _meta((gb, s, cfg.d_model), cfg.dtype),
            "dec_tokens": _meta((gb, max(s // 4, 16)), torch.int32),
        }
    if cfg.modality == "vision":
        fl, tl = _frontend_split(cfg, s)
        return {
            "tokens": _meta((gb, tl), torch.int32),
            "frontend_embeds": _meta((gb, fl, cfg.d_model), cfg.dtype),
        }
    return {"tokens": _meta((gb, s), torch.int32)}


def _batch_axes(name: str) -> Tuple:
    if name == "frontend_embeds":
        return ("batch", None, None)
    return ("batch", None)


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, NamedSharding]:
    return {
        k: sharding_for(tuple(v.shape), _batch_axes(k), mesh)
        for k, v in batch_specs(cfg, shape).items()
    }


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> Dict:
    """``{"params", "opt": {"step", "m", "v", "master"}[, "residual"]}``,
    each tree keyed by parameter name, as meta tensors: the parameters in
    their declared dtypes, the moments, masters and residual in float32."""
    params = {n: p.detach() for n, p in abstract_model(cfg).named_parameters()}

    def f32():
        return {n: _meta(p.shape, torch.float32) for n, p in params.items()}

    state = {
        "params": params,
        "opt": {"step": _meta((), torch.int32), "m": f32(), "v": f32(), "master": f32()},
    }
    if tcfg.grad_compression:
        state["residual"] = f32()
    return state


def state_shardings(cfg: ModelConfig, tcfg: TrainConfig, mesh) -> Dict:
    """Shardings matching :func:`abstract_train_state`'s structure."""
    named = param_shardings(cfg, mesh)
    rep = NamedSharding(mesh, logical_spec((), mesh))
    state = {
        "params": named,
        "opt": {"step": rep, "m": named, "v": named, "master": named},
    }
    if tcfg.grad_compression:
        state["residual"] = named
    return state


def opt_state_like(d: Dict):
    """An ``OptState`` of the dict trees of :func:`abstract_train_state` or
    :func:`state_shardings`."""
    from repro_torch.train.optimizer import OptState

    return OptState(step=d["step"], m=d["m"], v=d["v"], master=d["master"])


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    # kind -> {leaf: logical axes of one layer's cache}
    "attn": {"k": ("batch", None, "seq", None), "v": ("batch", None, "seq", None)},
    "rglru": {"h": ("batch", "tensor"), "conv": ("batch", None, "tensor")},
    "mlstm": {"C": ("batch", None, None, None), "n": ("batch", None, None),
              "m": ("batch", None)},
    "slstm": {"c": ("batch", "tensor"), "n": ("batch", "tensor"),
              "h": ("batch", "tensor"), "m": ("batch", "tensor")},
}


def cache_leaf_axes(kind: str, leaf: str) -> Tuple:
    """The logical axes of one leaf of a ``kind`` layer's decode cache."""
    return _CACHE_AXES[kind][leaf]


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """The abstract decode cache, made by the real initializers on the meta
    device: a list of per-layer dicts, or ``{"self": [...], "cross":
    [...]}`` for an encoder-decoder (its cross K/V over the full assigned
    sequence)."""
    gb, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        kv = (gb, cfg.n_kv_heads, s, cfg.head_dim)
        return {"self": ed.init_self_cache(gb, cfg, s, "meta"),
                "cross": [{"k": _meta(kv, cfg.dtype), "v": _meta(kv, cfg.dtype)}
                          for _ in range(cfg.n_layers)]}
    return tfm.init_decode_cache(gb, cfg, s, "meta")


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Any:
    """Shardings matching :func:`cache_specs`' structure (an axis that does
    not divide its dim, such as a batch of 1, is dropped)."""
    specs = cache_specs(cfg, shape)

    def layer(kind: str, leaves: Dict) -> Dict:
        table = _CACHE_AXES[kind]
        return {leaf: sharding_for(tuple(t.shape), table[leaf], mesh)
                for leaf, t in leaves.items()}

    if cfg.is_encoder_decoder:
        return {part: [layer("attn", c) for c in specs[part]] for part in ("self", "cross")}
    return [layer(cfg.pattern_for_layer(i), c) for i, c in enumerate(specs)]


# ---------------------------------------------------------------------------
# Microbatching heuristic (activation-memory driven)
# ---------------------------------------------------------------------------

def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Pick the gradient-accumulation count so each microbatch has <= 2
    sequences per data shard (bounds remat-saved activation memory)."""
    dp = mesh_axis_size(mesh, "batch")
    per_dev = max(shape.global_batch // max(dp, 1), 1)
    k = max(per_dev // 2, 1)
    while shape.global_batch % (k * 1) and k > 1:  # keep divisibility
        k -= 1
    while k > 1 and (shape.global_batch // k) % 1:
        k -= 1
    # ensure global batch divides k
    while k > 1 and shape.global_batch % k:
        k -= 1
    return k
