"""Carry model state and packed words between the reference and the port.

The reference package keeps a ``CoTMModel`` as ``ta_state`` uint8
``[C, 2o]`` and ``weights`` int32 ``[m, C]``, and packed literal words as
uint32.  The port keeps the same model arrays and carries words as int32
bit patterns.  These helpers take and give numpy arrays (anything
``np.asarray`` accepts), so this package needs nothing of the
reference's to read its state: ``freeze`` on both sides of
:func:`model_from_arrays` gives the same register image.
:func:`draws_from_arrays` builds a training step's :class:`TrainDraws`
from arrays, such as the uniforms and Gumbel noise the reference's
``jax.random`` keys give, so both packages can take the same step.

For the LM substrate, :func:`lm_params_from_arrays` takes the reference's
parameter tree (nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives) and returns the port's model;
:func:`lm_state_to_arrays` goes the other way, for a model (``{"params":
model}``), a whole train state (parameters, AdamW moments and masters, the
step, the compression residual) or gradients, and
:func:`lm_state_from_arrays` takes such a state back.  They are the one
place that knows both layouts: the reference stacks layers
(``layers.cyc[pos]`` with a leading cycle axis, ``layers.tail[i]``;
``enc``/``dec`` with a leading layer axis), the port lists them in layer
order.  The port's checkpoints of an LM train state are written in the
reference's layout, so either package resumes the other's run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cotm import CoTMModel
from repro_torch.core.train import TrainDraws
from repro_torch.launch.specs import model_decls
from repro_torch.models.base import ParamTree, _leaves, _param_at
from repro_torch.models.transformer import layer_split
from repro_torch.train.optimizer import OptState

__all__ = [
    "draws_from_arrays",
    "lm_params_from_arrays",
    "lm_state_from_arrays",
    "lm_state_to_arrays",
    "model_from_arrays",
    "model_to_arrays",
    "stacked_groups",
    "words_from_uint32",
    "words_to_uint32",
]


def model_from_arrays(ta_state, weights, device="cpu") -> CoTMModel:
    """A port ``CoTMModel`` from the reference model's arrays."""
    ta = np.asarray(ta_state)
    w = np.asarray(weights)
    if ta.ndim != 2 or w.ndim != 2 or w.shape[1] != ta.shape[0]:
        raise ValueError(
            f"expected ta_state [C, 2o] and weights [m, C]; got {ta.shape} and {w.shape}"
        )
    if ta.dtype != np.uint8:
        raise TypeError(f"ta_state must be uint8, got {ta.dtype}")
    return CoTMModel(
        ta_state=torch.tensor(ta, dtype=torch.uint8, device=device),
        weights=torch.tensor(w.astype(np.int32), dtype=torch.int32, device=device),
    )


def model_to_arrays(model: CoTMModel):
    """A port ``CoTMModel`` -> the reference's arrays (``ta_state`` uint8
    ``[C, 2o]``, ``weights`` int32 ``[m, C]``), as numpy."""
    return (model.ta_state.detach().cpu().numpy().astype(np.uint8),
            model.weights.detach().cpu().numpy().astype(np.int32))


def draws_from_arrays(gumbel, neg, u_t, u_q, u_ia1, u_ia0, u_ib, device="cpu") -> TrainDraws:
    """A :class:`TrainDraws` from numpy arrays: float32 ``gumbel [B, P, C]``,
    integer ``neg [B]``, float32 ``u_t``/``u_q [B, C]`` and
    ``u_ia1``/``u_ia0``/``u_ib [B, C, 2o]``.  Float arrays must already be
    float32: a conversion would change the draws."""
    floats = dict(gumbel=gumbel, u_t=u_t, u_q=u_q, u_ia1=u_ia1, u_ia0=u_ia0, u_ib=u_ib)
    out = {}
    for name, arr in floats.items():
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            raise TypeError(f"{name} must be float32, got {arr.dtype}")
        out[name] = torch.tensor(arr, device=device)
    b = out["u_t"].shape[0]
    neg = np.asarray(neg).astype(np.int64).reshape(b)
    return TrainDraws(neg=torch.tensor(neg, device=device), **out)


def words_to_uint32(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> the reference's uint32 words (same bits)."""
    return words.detach().cpu().numpy().view(np.uint32)


def words_from_uint32(words, device="cpu") -> torch.Tensor:
    """The reference's uint32 words -> an int32 word tensor (same bits)."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32)
    return torch.tensor(arr, device=device)


def _ref_index(cfg: ModelConfig, path):
    """The reference's location of the port's parameter at ``path``: the
    key path into its tree and the index along a stacked leading axis
    (None for an unstacked leaf)."""
    if cfg.is_encoder_decoder:
        if path[0] in ("enc", "dec"):
            return (path[0], *path[2:]), path[1]
        return path, None
    if path[0] != "layers":
        return path, None
    i, rest = path[1], path[2:]
    pattern, n_full, _ = layer_split(cfg)
    lp = len(pattern)
    if i < n_full * lp:
        return ("layers", "cyc", str(i % lp), *rest), i // lp
    return ("layers", "tail", str(i - n_full * lp), *rest), None


def stacked_groups(cfg: ModelConfig) -> list:
    """The port's parameter names grouped by the reference's leaves: one
    list per leaf of its tree, a stacked leaf's layers in their order along
    its leading axis, an unstacked leaf alone.  Flattening a group's
    tensors in order and joining them gives the reference's leaf
    flattened."""
    groups: dict = {}
    for path, _ in _leaves(model_decls(cfg)):
        keys, j = _ref_index(cfg, path)
        groups.setdefault(keys, []).append((-1 if j is None else j, _name(path)))
    return [[n for _, n in sorted(members)] for members in groups.values()]


def _tensor_from_array(arr) -> torch.Tensor:
    """A CPU tensor of ``arr``: a tensor as it is, a numpy array copied (an
    ``ml_dtypes`` bfloat16 array by its bits, read from the dtype's name, so
    ``ml_dtypes`` need not be loaded)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu()
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: carry the bits
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A fresh CPU copy of ``t``, which nothing else holds; a meta tensor
    (a shape template) stays as it is."""
    return t if t.is_meta else t.to("cpu", copy=True)


def _name(path) -> str:
    """The port's ``named_parameters()`` name of a declaration path."""
    return ".".join(map(str, path))


def _ref_leaf(cfg: ModelConfig, tree, path) -> torch.Tensor:
    """The reference's leaf for the port's parameter at ``path`` (its layer
    of a stacked array), as a CPU tensor."""
    keys, j = _ref_index(cfg, path)
    node = tree
    for k in keys:
        node = node[k]
    if j is not None:
        node = node[j] if isinstance(node, torch.Tensor) else np.asarray(node)[j]
    return _tensor_from_array(node)


def _to_ref_layout(cfg: ModelConfig, leaf_at, finish):
    """The reference's nested tree, layers stacked as its ``model_decls``
    stacks them, over the port's declaration paths: each of its leaves is
    ``finish`` of ``leaf_at(path)``, or of the stack of a group's layers.
    A stack is made where the layers are and finished before the next is
    made, so a state on the card is copied to the host one leaf at a time."""
    groups: dict = {}
    # The reference keeps both groups of its layers, empty or not.
    tree: dict = {} if cfg.is_encoder_decoder else {"layers": {"cyc": {}, "tail": {}}}
    for path, _ in _leaves(model_decls(cfg)):
        keys, j = _ref_index(cfg, path)
        groups.setdefault(keys, []).append((j, path))
    for keys, members in groups.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        j, path = members[0]
        node[keys[-1]] = finish(leaf_at(path) if j is None else torch.stack(
            [leaf_at(p) for _, p in sorted(members, key=lambda m: m[0])]))
    return tree


@torch.no_grad()
def lm_params_from_arrays(cfg: ModelConfig, tree, *, device, dtype=None) -> ParamTree:
    """The port's model of ``cfg`` holding the reference's parameters
    ``tree`` (nested dicts of numpy arrays or tensors).  Each parameter
    takes its declaration's dtype: ``cfg.dtype`` for the weights (``dtype``
    instead, when given) and float32 where the reference fixes it (norm
    scales, the router, ``r_rec``, ``b``, ``lambda_p``, ``shared_mix``)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    decls = model_decls(cfg)
    model = ParamTree(decls, device)
    for path, d in _leaves(decls):
        src = _ref_leaf(cfg, tree, path)
        if tuple(src.shape) != d.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: the reference's array has "
                             f"shape {tuple(src.shape)}, the port declares {d.shape}")
        _param_at(model, path).copy_(src.to(d.dtype))
    return model


def lm_state_to_arrays(state, cfg: ModelConfig) -> dict:
    """A train state (or any dict of its parts) in the reference's layout.

    ``state["params"]`` (the model), ``state["opt"]`` (an ``OptState``:
    ``step``, ``m``, ``v``, ``master``) and every other entry holding
    tensors keyed by parameter name (``residual``, gradients) become the
    reference's trees, layers stacked as its ``model_decls`` stacks them,
    under its checkpoint's leaf names (``params/...``, ``opt/.m/...``,
    ``opt/.step``).  Leaves are fresh CPU tensors in their own dtypes,
    which nothing else holds (numpy has no bfloat16 without ``ml_dtypes``,
    and the port's checkpointer writes bfloat16 tensors as the reference
    does); a state on the meta device gives a template of meta tensors,
    the shapes a restore needs.  The reference's parameter tree of a model
    alone is ``lm_state_to_arrays({"params": model}, cfg)["params"]``."""
    def tree_of(named):
        if isinstance(named, torch.nn.Module):
            named = dict(named.named_parameters())
        return _to_ref_layout(cfg, lambda path: named[_name(path)].detach(), _to_host)

    out = {}
    for key, part in state.items():
        if isinstance(part, OptState):
            out[key] = OptState(step=_to_host(part.step.detach()), m=tree_of(part.m),
                                v=tree_of(part.v), master=tree_of(part.master))
        else:
            out[key] = tree_of(part)
    return out


@torch.no_grad()
def lm_state_from_arrays(cfg: ModelConfig, tree, *, device) -> dict:
    """The port's train state (or any dict of its parts) on ``device`` from
    one in the reference's layout (:func:`lm_state_to_arrays`'s output, a
    restored checkpoint of either package, or the reference's own state as
    numpy arrays): ``params`` becomes the model in ``cfg.dtype`` with
    gradients on, ``opt`` (any object with ``step``, ``m``, ``v``,
    ``master``) an ``OptState`` in float32 with an int32 step, and every
    other entry (``residual``, gradients) tensors keyed by parameter name
    in their own dtypes."""
    decls = model_decls(cfg)

    def named(t, dtype=None):
        return {_name(path): _ref_leaf(cfg, t, path).to(device=device, dtype=dtype)
                for path, _ in _leaves(decls)}

    state = {}
    for key, part in tree.items():
        if key == "params":
            state[key] = lm_params_from_arrays(cfg, part, device=device).requires_grad_(True)
        elif key == "opt":
            f32 = torch.float32
            state[key] = OptState(
                step=_tensor_from_array(part.step).to(device=device, dtype=torch.int32
                                                      ).reshape(()),
                m=named(part.m, f32), v=named(part.v, f32), master=named(part.master, f32))
        else:
            state[key] = named(part)
    return state
