"""Batch-parallel ConvCoTM training engine (counterpart of
``repro/train/tm_engine.py``).

The training counterpart of ``serve.engine.ServingEngine``: where the
serving engine freezes a model once, the :class:`TrainerEngine` freezes
the *dataset* once (booleanize -> patches -> literals through the shared
ingress, resident on the engine's device for the whole run) and streams
the model through epochs:

  * an epoch is one Python loop over its steps on the device: a gather
    of the step's batch out of the dataset, that step's draws, the
    update.  Nothing in the loop reads a value back to the host, so the
    host runs ahead of the card;
  * the shuffle is ``data.pipeline.epoch_permutation`` and the cursor a
    checkpointable ``PipelineState``, so a run resumes where ``batches()``
    would;
  * the random numbers come from a *source*: a ``jax.random`` key
    (``core/prng.py``), advanced by the reference's ``key, k = split(key)``
    chain, one :func:`~repro_torch.core.train.make_draws` of ``k`` a step
    on the engine's device, so from one key both packages train the same
    model; or any iterator of :class:`~repro_torch.core.train.TrainDraws`,
    one per step (draws built elsewhere, as tests build them);
  * with a mesh (:class:`~repro_torch.launch.mesh.DeviceMesh`), batch
    mode is data-parallel: each step's literals, labels and draws are
    split over the devices along ``data_axis``, each shard computes its
    deltas on its device, and an exact int32 reduction
    (``distributed.collectives.tree_psum_batch``) combines them, so the
    model equals the unmeshed run's bit for bit.  The dataset, the model,
    its update and evaluation stay on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import clauses as cl
from repro_torch.core import prng
from repro_torch.core.cotm import CoTMConfig, CoTMModel, init_model
from repro_torch.core.ingress import IngressSpec, device_ingress
from repro_torch.core.train import TrainDraws, _step_literals, make_draws
from repro_torch.data.pipeline import PipelineState, epoch_permutation
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.spans import span

__all__ = ["EpochReport", "TMDataset", "TrainerEngine"]

#: Where a step's draws come from: a key, or one TrainDraws per step.
DrawSource = Union[torch.Tensor, Iterator[TrainDraws]]


@dataclasses.dataclass(frozen=True)
class TMDataset:
    """A dataset frozen for training: dense literals on the engine's device."""

    literals: torch.Tensor     # uint8 [N, P, 2o]
    labels: torch.Tensor       # int32 [N]

    @property
    def n(self) -> int:
        return self.literals.shape[0]


@dataclasses.dataclass
class EpochReport:
    """Per-epoch accounting returned by :meth:`TrainerEngine.fit`."""

    epoch: int
    samples: int
    seconds: float
    samples_per_s: float
    accuracy: Optional[float] = None


class TrainerEngine:
    """Full-epoch ConvCoTM training over precomputed literals.

    Args:
      config: the ConvCoTM hyper-parameters (``config.train_eval`` picks
        the training clause evaluation, matmul by default).
      batch_size: samples per update step.
      mode: ``'batch'`` (summed per-sample deltas, the data-parallel
        mode) or ``'scan'`` (each sample applied in turn: exact TMU
        semantics, one device only).
      mesh: optional :class:`~repro_torch.launch.mesh.DeviceMesh`; batch
        mode then splits each step over the devices along ``data_axis``
        (``batch_size`` must divide by that axis' size).
      data_axis: the mesh axis that carries data parallelism.
      eval_batch: chunk size of :meth:`evaluate`.
      device: where the dataset and the model live; by default the CUDA
        card, and with no card a ``RuntimeError`` (``device="cpu"`` runs on
        the CPU).  With a mesh, its first device along ``data_axis``.
    """

    #: prepare() chunk size: bounds the ingress temporaries.
    INGRESS_CHUNK = 4096

    def __init__(
        self,
        config: CoTMConfig,
        *,
        batch_size: int = 100,
        mode: str = "batch",
        mesh: Optional[DeviceMesh] = None,
        data_axis: str = "data",
        eval_batch: int = 1024,
        device=None,
    ):
        if mode not in ("batch", "scan"):
            raise ValueError(f"unknown mode {mode!r}; expected 'batch' or 'scan'")
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh; got {type(mesh).__name__}")
        if mode == "scan" and mesh is not None:
            raise ValueError(
                "mode='scan' is strictly sequential (exact TMU semantics) and cannot be "
                "data-parallel; use mode='batch' with a mesh"
            )
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if mesh is not None:
            if data_axis not in mesh.axis_names:
                raise ValueError(f"data_axis {data_axis!r} not in mesh axes {mesh.axis_names}")
            axis_size = mesh.shape[data_axis]
            if batch_size % axis_size:
                raise ValueError(
                    f"batch_size={batch_size} must divide evenly over mesh axis "
                    f"{data_axis!r} (size {axis_size})"
                )
            first = mesh.along(data_axis)[0]
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
        if eval_batch < 1:
            raise ValueError("eval_batch must be >= 1")
        self.config = config
        self.batch_size = batch_size
        self.mode = mode
        self.mesh = mesh
        self.data_axis = data_axis
        self.eval_batch = eval_batch
        self.device = resolve_device(device)

    # --- dataset ingress --------------------------------------------------

    def prepare(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        *,
        booleanize_method: str = "threshold",
        **booleanize_kw,
    ) -> TMDataset:
        """Freeze a dataset: raw pixels to the device in chunks, the ingress
        (booleanize -> patches -> dense literals) there, once."""
        spec = IngressSpec(patch=self.config.patch, method=booleanize_method, packed=False,
                           **booleanize_kw)
        x = np.asarray(images)
        chunks = [
            device_ingress(spec, torch.from_numpy(np.ascontiguousarray(
                x[i : i + self.INGRESS_CHUNK])).to(self.device))
            for i in range(0, len(x), self.INGRESS_CHUNK)
        ]
        lits = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
        y = torch.from_numpy(np.asarray(labels).astype(np.int32)).to(self.device)
        return TMDataset(literals=lits.to(torch.uint8), labels=y)

    def init_model(self, key: torch.Tensor) -> CoTMModel:
        """The reference's initial model (TAs at N-1, weights random +-1)
        from ``key``, on the engine's device."""
        return init_model(key.to(self.device), self.config)

    # --- epochs -----------------------------------------------------------

    def _draws(self, source: DrawSource) -> Tuple[DrawSource, TrainDraws]:
        """(the advanced source, one step's draws)."""
        if isinstance(source, torch.Tensor):
            source, k = prng.split(source.to(self.device)).unbind(0)
            return source, make_draws(k, self.batch_size, self.config)
        return source, next(source).to(self.device)

    def run_epoch(
        self,
        source: DrawSource,
        model: CoTMModel,
        ds: TMDataset,
        state: Optional[PipelineState] = None,
    ) -> Tuple[DrawSource, CoTMModel, PipelineState, int]:
        """Run (the rest of) one epoch from ``state``.

        A mid-epoch cursor skips the steps already trained; a cursor past
        the epoch's last step trains the next epoch, as ``batches()`` does.
        Returns ``(source, model, rolled-over cursor, samples trained)``;
        the source has advanced by one step's draws per step (a key is
        returned advanced, as the reference's ``run_epoch`` returns it).
        """
        state = state or PipelineState()
        b = self.batch_size
        n_steps = ds.n // b
        if n_steps == 0:
            raise ValueError(
                f"dataset has {ds.n} samples < batch_size={b}; an epoch would "
                f"train nothing: shrink batch_size or grow the dataset"
            )
        if state.step >= n_steps:
            state = PipelineState(state.epoch + 1, 0, state.seed)
        perm = epoch_permutation(state.seed, state.epoch, ds.n)
        steps = n_steps - state.step
        idx = torch.from_numpy(
            perm[state.step * b : n_steps * b].reshape(steps, b).astype(np.int64)
        ).to(self.device)
        for s in range(steps):
            with span("train.draws"):
                source, draws = self._draws(source)
            ix = idx[s]
            model = _step_literals(draws, model, ds.literals[ix], ds.labels[ix],
                                   self.config, self.mode, self.mesh, self.data_axis)
        return source, model, PipelineState(state.epoch + 1, 0, state.seed), steps * b

    def _sync(self):
        devices = (self.device,) if self.mesh is None else dict.fromkeys(self.mesh.flat)
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # --- evaluation -------------------------------------------------------

    @torch.inference_mode()
    def predict(self, model: CoTMModel, ds: TMDataset) -> torch.Tensor:
        """Predictions int32 ``[N]`` on the matmul path over the prepared
        literals, in ``eval_batch`` chunks, on the device (no host read)."""
        include = model.include
        nonempty = cl.clause_nonempty(include)
        preds = []
        for i in range(0, ds.n, self.eval_batch):
            fired = cl.eval_clauses_matmul(ds.literals[i : i + self.eval_batch], include,
                                           nonempty)
            preds.append(cl.argmax_predict(cl.class_sums(fired, model.weights)))
        return torch.cat(preds)

    def evaluate(self, model: CoTMModel, ds: TMDataset) -> float:
        """Accuracy on a prepared dataset: the correct count stays on the
        device and is read once."""
        correct = (self.predict(model, ds) == ds.labels).sum()
        return int(correct) / ds.n

    def freeze_servable(self, model: CoTMModel, state: Optional[PipelineState] = None):
        """Freeze a trained model into a servable stamped with the training
        cursor and the register image's digest (the engine assigns the
        version id at ``register``)."""
        from repro_torch.serve.servable import ServableVersion, freeze, servable_digest

        servable = freeze(model, self.config)
        state = state or PipelineState()
        servable.version = ServableVersion(version=0, epoch=state.epoch, step=state.step,
                                           digest=servable_digest(servable))
        return servable

    # --- driver -----------------------------------------------------------

    def fit(
        self,
        source: DrawSource,
        model: CoTMModel,
        train_ds: TMDataset,
        *,
        epochs: int,
        eval_ds: Optional[TMDataset] = None,
        state: Optional[PipelineState] = None,
        log=None,
    ) -> Tuple[DrawSource, CoTMModel, PipelineState, List[EpochReport]]:
        """Train ``epochs`` further epochs from the ``state`` cursor; returns
        ``(source, model, cursor, reports)``.  An epoch's time runs from
        its first launch to the card's finishing its last step."""
        state = state or PipelineState()
        reports: List[EpochReport] = []
        for _ in range(epochs):
            self._sync()
            t0 = time.perf_counter()
            source, model, state, n = self.run_epoch(source, model, train_ds, state)
            self._sync()
            dt = time.perf_counter() - t0
            rep = EpochReport(
                epoch=state.epoch - 1,
                samples=n,
                seconds=dt,
                samples_per_s=n / dt if dt > 0 else 0.0,
                accuracy=self.evaluate(model, eval_ds) if eval_ds else None,
            )
            reports.append(rep)
            if log is not None:
                acc = f"  acc {rep.accuracy:.4f}" if rep.accuracy is not None else ""
                log(f"epoch {rep.epoch}:{acc}  ({rep.samples_per_s:,.0f} samples/s, "
                    f"{rep.seconds:.2f}s)")
        return source, model, state, reports
