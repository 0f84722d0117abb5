"""Input pipeline: booleanize -> (optionally bit-pack) -> batches -> prefetch
(counterpart of ``repro/data/pipeline.py``).

The host-side ingress here (:func:`preprocess_for_serving`) runs the same
port functions as the device ingress (``core/ingress.py``) on CPU
tensors and returns numpy arrays, packed words as uint32 like the
reference's; the serving engine's ``ingress='host'`` and
``preprocessed=True`` request forms take them.  :func:`epoch_permutation`
is the reference's numpy ``SeedSequence([seed, epoch])`` shuffle, so both
packages walk a dataset in the same order for the same cursor, and
:class:`PipelineState` is the checkpointable cursor.
:class:`DoubleBufferedLoader` keeps the next batch's copy to the card in
flight (pinned host memory, ``non_blocking`` copies), as the ASIC's second
image buffer does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.booleanize import booleanize
from repro_torch.core.ingress import _with_feature_axes
from repro_torch.core.patches import PatchSpec, extract_patch_features, make_literals, pack_bits

__all__ = [
    "DoubleBufferedLoader",
    "PipelineState",
    "batches",
    "booleanize_split",
    "epoch_permutation",
    "literals_host",
    "pack_literals_host",
    "preprocess_for_serving",
]


@dataclasses.dataclass
class PipelineState:
    """Checkpointable cursor: (epoch, step within the epoch, shuffle seed)."""

    epoch: int = 0
    step: int = 0
    seed: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def booleanize_split(images: np.ndarray, method: str = "threshold", **kw) -> np.ndarray:
    """Host-side batch booleanization (uint8 0/1)."""
    return booleanize(torch.from_numpy(np.ascontiguousarray(images)), method=method,
                      **kw).numpy()


def _features(bool_images: np.ndarray, spec: PatchSpec) -> torch.Tensor:
    bits = _with_feature_axes(torch.from_numpy(np.ascontiguousarray(bool_images)), spec)
    return extract_patch_features(bits, spec)


def literals_host(bool_images: np.ndarray, spec: PatchSpec) -> np.ndarray:
    """Host-side dense literals uint8 ``[B, P, 2o]``, from ``[B, Y, X]`` or
    with trailing channel / thermometer axes."""
    return make_literals(_features(bool_images, spec)).numpy()


def pack_literals_host(bool_images: np.ndarray, spec: PatchSpec) -> np.ndarray:
    """Host-side packed literals uint32 ``[B, P, W]`` (the reference's words)."""
    words = pack_bits(make_literals(_features(bool_images, spec)), spec.n_words)
    return words.numpy().view(np.uint32)


def preprocess_for_serving(
    raw_images: np.ndarray,
    spec: PatchSpec,
    method: str = "threshold",
    packed: bool = True,
    **booleanize_kw,
) -> np.ndarray:
    """The host-side serving ingress: booleanize -> patches -> literals
    [-> pack].  ``method='none'`` skips booleanization (inputs already
    0/1).  Equal, bit for bit, to the device ingress of the same spec."""
    x = np.asarray(raw_images)
    if method != "none":
        x = booleanize_split(x, method, **booleanize_kw)
    x = x.astype(np.uint8)
    if packed:
        return pack_literals_host(x, spec)
    return literals_host(x, spec)


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The deterministic shuffle of epoch ``epoch`` under ``seed``: a
    ``SeedSequence`` of the pair ``(seed, epoch)``, as in the reference."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n)


def batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    state: Optional[PipelineState] = None,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray, PipelineState]]:
    """Shuffled epoch iterator that resumes from a :class:`PipelineState`.

    Each yielded state is the cursor to resume *after* that batch; the one
    yielded with the epoch's last batch rolls over to ``(epoch + 1, 0)``.
    A cursor already past the epoch's last step starts the next epoch.
    """
    state = state or PipelineState()
    n = x.shape[0]
    n_steps = n // batch_size if drop_remainder else (n + batch_size - 1) // batch_size
    if n_steps and state.step >= n_steps:
        state = PipelineState(state.epoch + 1, 0, state.seed)
    perm = epoch_permutation(state.seed, state.epoch, n)
    for step in range(state.step, n_steps):
        idx = perm[step * batch_size : (step + 1) * batch_size]
        if step + 1 == n_steps:
            cursor = PipelineState(state.epoch + 1, 0, state.seed)
        else:
            cursor = PipelineState(state.epoch, step + 1, state.seed)
        yield x[idx], y[idx], cursor


class DoubleBufferedLoader:
    """Keeps the next batch's copy to ``device`` in flight.

    Each numpy batch is staged in pinned host memory and copied with
    ``non_blocking=True`` (on the card the copy of batch k+1 overlaps the
    work on batch k); on the CPU the arrays are wrapped without a copy.
    Yields ``(x, y, state)`` with tensors on ``device``: the card unless
    ``"cpu"`` is named (see :func:`repro_torch.resolve_device`).
    """

    def __init__(self, it, device=None):
        self._it = iter(it)
        self._device = resolve_device(device)
        self._next = None
        self._prime()

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._device.type == "cpu":
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def _prime(self):
        try:
            x, y, st = next(self._it)
            self._next = (self._put(x), self._put(y), st)
        except StopIteration:
            self._next = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._next is None:
            raise StopIteration
        out = self._next
        self._prime()
        return out
