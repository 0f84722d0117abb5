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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cotm import CoTMModel
from repro_torch.core.train import TrainDraws

__all__ = [
    "draws_from_arrays",
    "model_from_arrays",
    "model_to_arrays",
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
