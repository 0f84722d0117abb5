"""ConvCoTM training (counterpart of ``repro/core/train.py``).

The CoTM update rule with convolution, per sample (X, y) with clause
outputs c_j ORed over patches:

  * target class y updates with probability (T - clip(v_y)) / 2T, one
    sampled negative class q with (T + clip(v_q)) / 2T;
  * a clause drawn for class i gets Type I feedback if its weight has
    positive polarity for the target (negative for the negative class),
    else Type II, and its weight moves by +1 (target) / -1 (negative)
    when the clause fired;
  * Type Ia (c = 1) uses the literals of one patch drawn uniformly among
    those where the clause matched (a Gumbel argmax); literal 1 -> TA +1
    (always with ``boost_true_positive``, else with probability
    (s - 1) / s), literal 0 -> TA -1 with probability 1/s; Type Ib
    (c = 0): every TA -1 with probability 1/s; Type II (c = 1): 0-literals
    whose action is exclude -> TA +1;
  * with ``max_included_literals``, no new include once a clause is at
    its budget.

Training is random.  Every random number a step consumes is an explicit
:class:`TrainDraws`, made by :func:`make_draws` from the step's
``jax.random`` key (``core/prng.py``, on the key's device) exactly as the
reference's ``sample_deltas_literals`` draws them, so from one key both
packages take the same step.  Every comparison is ``uniform < p`` in
float32, as ``jax.random.bernoulli`` draws it.

Two application modes: ``batch`` sums the per-sample deltas in int32 and
applies them once; ``scan`` applies each sample in turn (exact TMU
semantics).  Batch mode is data-parallel over a device mesh: each data
shard computes its rows' deltas on its device, and
:func:`~repro_torch.distributed.collectives.tree_psum_batch` sums them
exactly, so the update equals the unmeshed one bit for bit.
``config.train_eval`` picks the per-patch clause outputs:
``matmul`` (float32 violation counts) or ``dense`` (the broadcast); both
give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import clauses as cl
from repro_torch.core import prng
from repro_torch.core.cotm import TA_HALF, WEIGHT_MAX, WEIGHT_MIN, CoTMConfig, CoTMModel
from repro_torch.core.patches import extract_patch_features, make_literals
from repro_torch.distributed.collectives import tree_psum_batch
from repro_torch.spans import span

__all__ = [
    "TrainDraws",
    "accuracy",
    "batch_literals",
    "make_draws",
    "sample_deltas",
    "sample_deltas_literals",
    "update_batch",
    "update_batch_literals",
]


@dataclasses.dataclass
class TrainDraws:
    """The random numbers one training step consumes, per sample.

    * ``gumbel`` float32 ``[B, P, C]``: patch-selection noise;
    * ``neg`` int ``[B]``: the negative class draw in ``[0, m - 1)``, before
      the shift past the label;
    * ``u_t``, ``u_q`` float32 ``[B, C]``: target / negative update draws;
    * ``u_ia1``, ``u_ia0``, ``u_ib`` float32 ``[B, C, 2o]``: Type Ia
      increment, Type Ia decrement and Type Ib decrement draws.
    """

    gumbel: torch.Tensor
    neg: torch.Tensor
    u_t: torch.Tensor
    u_q: torch.Tensor
    u_ia1: torch.Tensor
    u_ia0: torch.Tensor
    u_ib: torch.Tensor

    def __getitem__(self, i) -> "TrainDraws":
        """The draws of samples ``i`` (an index or a slice)."""
        if isinstance(i, int):
            i = slice(i, i + 1)
        return TrainDraws(**{f.name: getattr(self, f.name)[i]
                             for f in dataclasses.fields(self)})

    def to(self, device) -> "TrainDraws":
        return TrainDraws(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def make_draws(key: torch.Tensor, batch: int, config: CoTMConfig) -> TrainDraws:
    """One step's draws for ``batch`` samples from the step's key, on its
    device: the reference's ``split(key, batch)``, then per sample
    ``split(k, 7)`` into the patch, negative-class, target, negative,
    Type Ia increment, Type Ia decrement and Type Ib keys, each drawn as
    ``sample_deltas_literals`` draws it (Gumbel noise ``[P, C]``, the
    negative class in ``[0, m - 1)``, uniforms ``[C]`` and ``[C, 2o]``)."""
    p, c, n, m = (config.patch.n_patches, config.n_clauses, config.n_literals,
                  config.n_classes)
    keys = prng.split(prng.split(key, batch), 7)
    # Keys of one shape draw in one call: each key's numbers are its own.
    u_t, u_q = prng.uniform(keys[:, 2:4], (c,)).unbind(1)
    u_ia1, u_ia0, u_ib = prng.uniform(keys[:, 4:7], (c, n)).unbind(1)
    return TrainDraws(gumbel=prng.gumbel(keys[:, 0], (p, c)),
                      neg=prng.randint(keys[:, 1], (), 0, m - 1),
                      u_t=u_t, u_q=u_q, u_ia1=u_ia1, u_ia0=u_ia0, u_ib=u_ib)


def _train_patch_outputs(lits: torch.Tensor, include: torch.Tensor,
                         config: CoTMConfig) -> torch.Tensor:
    """Per-patch clause outputs ``[B, P, C]`` with the training rule (an
    empty clause outputs 1), by ``config.train_eval``."""
    if config.train_eval == "matmul":
        return cl.patch_clause_outputs_matmul(lits, include, training=True)
    if config.train_eval == "dense":
        return cl.patch_clause_outputs(lits, include, training=True)
    raise ValueError(
        f"unknown train_eval {config.train_eval!r}; expected 'matmul' or 'dense'"
    )


def batch_literals(images: torch.Tensor, config: CoTMConfig) -> torch.Tensor:
    """Booleanized images ``[B, Y, X]`` -> dense literals ``[B, P, 2o]``."""
    return make_literals(extract_patch_features(images, config.patch))


def sample_deltas_literals(
    draws: TrainDraws,
    model: CoTMModel,
    lits: torch.Tensor,
    labels: torch.Tensor,
    config: CoTMConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample TA and weight deltas of a batch, from its literals.

    ``lits`` uint8 ``[B, P, 2o]``, ``labels`` int ``[B]``, ``draws`` for the
    same B samples.  Returns (ta_delta int8 ``[B, C, 2o]``, w_delta int32
    ``[B, m, C]``); each sample sees the same ``model``.
    """
    b = lits.shape[0]
    dev = lits.device
    include = model.include                                          # [C, 2o]
    with span("train.matmul"):
        cp = _train_patch_outputs(lits, include, config)             # [B, P, C]
    with span("train.feedback"):
        fired = (cp > 0).any(dim=1)                                  # bool [B, C]
        # Uniform choice among matching patches: the first maximum of the
        # Gumbel scores (patch 0 for a clause that matched nowhere, which
        # the callers gate on ``fired``).
        score = torch.where(cp > 0, draws.gumbel, float("-inf"))
        idx = score.argmax(dim=1)                                    # [B, C]
        n = lits.shape[-1]
        sel = torch.gather(lits, 1, idx[..., None].expand(-1, -1, n))   # [B, C, 2o]

        v = cl.class_sums(fired, model.weights)                      # [B, m]
        v = torch.clamp(v, -config.T, config.T)
        y = labels.to(torch.int64)
        q = draws.neg.to(torch.int64)
        q = torch.where(q >= y, q + 1, q)
        v_y = v.gather(1, y[:, None])[:, 0]
        v_q = v.gather(1, q[:, None])[:, 0]
        # True float32 divisions by a tensor on the same device (a host
        # scalar divisor may become a multiply by its reciprocal).
        two_t = torch.full((b,), 2.0 * config.T, dtype=torch.float32, device=dev)
        p_t = (config.T - v_y).to(torch.float32) / two_t
        p_q = (config.T + v_q).to(torch.float32) / two_t
        upd_t = draws.u_t < p_t[:, None]                             # [B, C]
        upd_q = draws.u_q < p_q[:, None]

        pos_t = model.weights[y] >= 0                                # [B, C]
        pos_q = model.weights[q] >= 0
        type1 = (upd_t & pos_t) | (upd_q & ~pos_q)
        type2 = (upd_t & ~pos_t) | (upd_q & pos_q)

        # float32 thresholds made on the device (a host tensor copied over
        # would wait for the card once per step).
        s = config.s
        p_inc = torch.full((), 1.0 if config.boost_true_positive else (s - 1.0) / s,
                           dtype=torch.float32, device=dev)
        inv_s = torch.full((), 1.0 / s, dtype=torch.float32, device=dev)
        lit1 = sel > 0
        inc_draw = (draws.u_ia1 < p_inc).to(torch.int8)
        dec_draw = (draws.u_ia0 < inv_s).to(torch.int8)
        dec_draw_ib = (draws.u_ib < inv_s).to(torch.int8)

        fired_b = fired[..., None]
        if config.max_included_literals is not None:
            n_inc = include.sum(dim=-1, dtype=torch.int32)[:, None]  # [C, 1]
            may_grow = ((n_inc < config.max_included_literals) | (include > 0)).to(torch.int8)
        else:
            may_grow = torch.ones_like(include, dtype=torch.int8)
        d_ia = torch.where(lit1, inc_draw * may_grow, -dec_draw)
        d_t1 = torch.where(fired_b, d_ia, -dec_draw_ib) * type1[..., None].to(torch.int8)
        excl = include == 0
        d_t2 = (~lit1 & excl & fired_b & type2[..., None]).to(torch.int8) * may_grow
        ta_delta = d_t1 + d_t2                                       # [B, C, 2o]

        rows = torch.arange(b, device=dev)
        w_delta = torch.zeros((b, config.n_classes, config.n_clauses), dtype=torch.int32,
                              device=dev)
        w_delta[rows, y] += (upd_t & fired).to(torch.int32)
        w_delta[rows, q] -= (upd_q & fired).to(torch.int32)
    return ta_delta, w_delta


def sample_deltas(
    draws: TrainDraws,
    model: CoTMModel,
    images: torch.Tensor,
    labels: torch.Tensor,
    config: CoTMConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_deltas_literals` from booleanized images ``[B, Y, X]``."""
    return sample_deltas_literals(draws, model, batch_literals(images, config), labels, config)


def _apply(model: CoTMModel, ta_delta: torch.Tensor, w_delta: torch.Tensor) -> CoTMModel:
    """Add summed deltas and clamp: TA states to [0, 2N - 1], weights to
    the int8 range [-127, 127]."""
    ta = torch.clamp(model.ta_state.to(torch.int32) + ta_delta.to(torch.int32),
                     0, 2 * TA_HALF - 1).to(torch.uint8)
    w = torch.clamp(model.weights + w_delta, WEIGHT_MIN, WEIGHT_MAX)
    return CoTMModel(ta_state=ta, weights=w)


def _step_literals(
    draws: TrainDraws,
    model: CoTMModel,
    lits: torch.Tensor,
    labels: torch.Tensor,
    config: CoTMConfig,
    mode: str,
    mesh=None,
    data_axis: str = "data",
) -> CoTMModel:
    """One training step over a batch of literals.  With a ``mesh``
    (:class:`~repro_torch.launch.mesh.DeviceMesh`, batch mode), the
    batch's rows, labels and draws are split over the devices along
    ``data_axis``; each shard computes its deltas on its device with a
    copy of the model there, the int32 sums meet in
    :func:`~repro_torch.distributed.collectives.tree_psum_batch`, and the
    update runs on the model's device."""
    if mode == "batch":
        if mesh is None:
            ta_d, w_d = sample_deltas_literals(draws, model, lits, labels, config)
            with span("train.apply"):
                return _apply(model, ta_d.sum(dim=0, dtype=torch.int32),
                              w_d.sum(dim=0, dtype=torch.int32))
        deltas = _shard_deltas(draws, model, lits, labels, config, mesh.along(data_axis))
        with span("train.apply"):
            ta_sum, w_sum = tree_psum_batch(deltas, mesh=mesh, axis=data_axis)
            return _apply(model, ta_sum.to(model.ta_state.device),
                          w_sum.to(model.weights.device))
    if mode == "scan":
        if mesh is not None:
            raise ValueError(
                "mode='scan' is strictly sequential (exact TMU semantics) and cannot be "
                "data-parallel; use mode='batch' with a mesh"
            )
        for i in range(lits.shape[0]):
            ta_d, w_d = sample_deltas_literals(draws[i], model, lits[i : i + 1],
                                               labels[i : i + 1], config)
            with span("train.apply"):
                model = _apply(model, ta_d[0], w_d[0])
        return model
    raise ValueError(f"unknown mode: {mode}")


def _shard_deltas(draws, model, lits, labels, config, devices):
    """Per-shard (TA, weight) deltas as lists of row blocks, one per device
    of ``devices``, each computed on its device (the int8 TA deltas are
    summed in int32 by the reduction)."""
    b, n = lits.shape[0], len(devices)
    if b % n:
        raise ValueError(f"batch {b} does not divide over {n} data shards")
    k = b // n
    replicas = {}
    ta_blocks, w_blocks = [], []
    for i, dev in enumerate(devices):
        if dev not in replicas:
            replicas[dev] = CoTMModel(ta_state=model.ta_state.to(dev),
                                      weights=model.weights.to(dev))
        rows = slice(i * k, (i + 1) * k)
        ta_d, w_d = sample_deltas_literals(draws[rows].to(dev), replicas[dev],
                                           lits[rows].to(dev), labels[rows].to(dev), config)
        ta_blocks.append(ta_d)
        w_blocks.append(w_d)
    return ta_blocks, w_blocks


def update_batch_literals(
    draws: TrainDraws,
    model: CoTMModel,
    lits: torch.Tensor,
    labels: torch.Tensor,
    config: CoTMConfig,
    mode: str = "batch",
) -> CoTMModel:
    """One training step over precomputed literals ``[B, P, 2o]``."""
    return _step_literals(draws, model, lits, labels, config, mode)


def update_batch(
    draws: TrainDraws,
    model: CoTMModel,
    images: torch.Tensor,
    labels: torch.Tensor,
    config: CoTMConfig,
    mode: str = "batch",
) -> CoTMModel:
    """One training step over a batch of booleanized images."""
    return _step_literals(draws, model, batch_literals(images, config), labels, config, mode)


def accuracy(
    model: CoTMModel, images: torch.Tensor, labels: torch.Tensor, config: CoTMConfig
) -> float:
    """Share of booleanized ``images`` whose prediction equals ``labels``."""
    from repro_torch.core.cotm import infer

    pred, _ = infer(model, images, config)
    return float((pred == labels.to(pred.device)).to(torch.float32).mean())
