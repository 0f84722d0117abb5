"""Zero-downtime model lifecycle driver: train -> shadow -> promote
(counterpart of ``repro/launch/lifecycle.py``).

It wires the training engine to a live serving engine through the hot
swap lifecycle:

  1. **train**    — ``TrainerEngine.fit`` advances the candidate a round
     of epochs from the checkpointable cursor; the draws come from a
     ``jax.random`` key (or any draw source the trainer takes), which
     each round takes and returns advanced, as the reference's does;
  2. **freeze**   — ``TrainerEngine.freeze_servable`` stamps the frozen
     image with a :class:`~repro_torch.serve.servable.ServableVersion`
     (epoch/step from the cursor, content digest);
  3. **shadow**   — the candidate registers under ``<name>@shadow`` on
     the live engine (its own sparsity analysis, and its own autotune pass
     with ``autotune_candidate``) and is scored against the live version
     **on the same mirrored requests**;
  4. **promote or reject** — promotion requires prediction agreement >=
     ``min_agreement`` and, when labels ride along, candidate accuracy
     no worse than live minus ``allow_accuracy_drop``; a promoted
     candidate installs via ``ServingEngine.swap`` (in-flight work
     completes on the old version; ``rollback()`` undoes it instantly),
     a rejected one leaves the live version untouched; a candidate tuned
     while shadowing carries its plan onto the live slot.

One-shot CLI round trip on the card (``--device cpu`` for the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.lifecycle \
        --arch convcotm-mnist --rounds 2 --epochs 1 --shadow-requests 128 [--autotune]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.cotm import CoTMModel
from repro_torch.data.pipeline import PipelineState
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.servable import ServableModel, ServableVersion
from repro_torch.train.tm_engine import DrawSource, TMDataset, TrainerEngine

__all__ = ["LifecycleConfig", "ShadowReport", "LifecycleDriver", "shadow_slot"]


def shadow_slot(name: str) -> str:
    """The engine slot a candidate shadows under (``<name>@shadow``)."""
    return f"{name}@shadow"


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Promotion policy knobs.

    ``min_agreement``      — fraction of mirrored requests on which the
                             candidate must predict the same class as
                             the live version (1.0 = bit-stable gate).
    ``allow_accuracy_drop``— with labels, the candidate may be at most
                             this much less accurate than live (0.0 =
                             never promote a regression).
    ``shadow_requests``    — mirrored requests per shadow evaluation.
    ``autotune_candidate`` — run the per-bucket autotuner on the shadow
                             slot, and promote the candidate with the
                             plan measured there.
    ``checkpoint_promoted``— save every promoted servable (stamp and
                             plan) via ``checkpoint.save_servable`` when a
                             ``ckpt_dir`` is configured.
    """

    min_agreement: float = 0.98
    allow_accuracy_drop: float = 0.0
    shadow_requests: int = 256
    autotune_candidate: bool = False
    checkpoint_promoted: bool = True

    def __post_init__(self):
        if not 0.0 <= self.min_agreement <= 1.0:
            raise ValueError("min_agreement must be in [0, 1]")
        if self.allow_accuracy_drop < 0:
            raise ValueError("allow_accuracy_drop must be >= 0")
        if self.shadow_requests < 1:
            raise ValueError("shadow_requests must be >= 1")


@dataclasses.dataclass
class ShadowReport:
    """One shadow evaluation: candidate vs live on mirrored traffic."""

    n: int                               # mirrored requests scored
    agreement: float                     # fraction of matching predictions
    live_version: int                    # live monotonic id during scoring
    candidate_digest: str                # candidate content digest
    live_accuracy: Optional[float] = None
    candidate_accuracy: Optional[float] = None
    promoted: bool = False
    promoted_version: Optional[int] = None
    reason: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class LifecycleDriver:
    """Train -> freeze -> shadow -> promote/reject over a live engine.

    The driver owns no event loop: it changes the engine through its
    public lifecycle API only (``register``/``swap``/``rollback``), so it
    composes with a running
    :class:`~repro_torch.serve.service.ServingService` — swaps land
    atomically under load and the service's requests keep their
    admission version.
    """

    def __init__(
        self,
        trainer: TrainerEngine,
        engine: ServingEngine,
        name: str,
        *,
        config: Optional[LifecycleConfig] = None,
        ckpt_dir: Optional[str] = None,
        booleanize_method: str = "threshold",
        eval_path: Optional[str] = None,
    ):
        self.trainer = trainer
        self.engine = engine
        self.name = name
        self.config = config or LifecycleConfig()
        self.ckpt_dir = ckpt_dir
        self.booleanize_method = booleanize_method
        self.eval_path = eval_path
        self.reports: List[ShadowReport] = []

    # --- train ------------------------------------------------------------

    def train_candidate(
        self,
        source: DrawSource,
        model: CoTMModel,
        train_ds: TMDataset,
        *,
        epochs: int = 1,
        state: Optional[PipelineState] = None,
    ) -> Tuple[DrawSource, CoTMModel, PipelineState, ServableModel]:
        """Advance training one round and freeze the stamped candidate."""
        source, model, state, _ = self.trainer.fit(
            source, model, train_ds, epochs=epochs, state=state
        )
        return source, model, state, self.trainer.freeze_servable(model, state)

    # --- shadow -----------------------------------------------------------

    def shadow_evaluate(
        self,
        candidate: ServableModel,
        requests: np.ndarray,
        labels: Optional[np.ndarray] = None,
    ) -> ShadowReport:
        """Score the candidate against the live version on the SAME
        requests (mirrored traffic), without touching the live slot.

        The candidate registers under :func:`shadow_slot` — a real
        registration on the live engine, so it gets its own sparsity
        analysis (and autotune pass, when configured) exactly as promotion
        would install it.  Each mirrored batch classifies on both slots;
        agreement is the fraction of identical predicted classes, and
        accuracies are computed when ``labels`` ride along.
        """
        cfg = self.config
        slot = shadow_slot(self.name)
        self.engine.register(slot, candidate, booleanize_method=self.booleanize_method,
                             path=self.eval_path, autotune=cfg.autotune_candidate)
        if cfg.autotune_candidate:
            self.engine.autotune(slot)
        n = min(len(requests), cfg.shadow_requests)
        live = self.engine.classify(self.name, requests[:n])
        shadow = self.engine.classify(slot, requests[:n])
        report = ShadowReport(
            n=n,
            agreement=float(np.mean(live.predictions == shadow.predictions)),
            live_version=live.version,
            candidate_digest=candidate.version.digest if candidate.version else "",
        )
        if labels is not None:
            y = np.asarray(labels[:n], np.int64)
            report.live_accuracy = float(np.mean(live.predictions == y))
            report.candidate_accuracy = float(np.mean(shadow.predictions == y))
        return report

    # --- promote / reject -------------------------------------------------

    def gate(self, report: ShadowReport) -> Tuple[bool, str]:
        """The promotion decision for one shadow report."""
        cfg = self.config
        if report.agreement < cfg.min_agreement:
            return False, f"agreement {report.agreement:.4f} < {cfg.min_agreement:.4f}"
        if (
            report.live_accuracy is not None
            and report.candidate_accuracy is not None
            and report.candidate_accuracy < report.live_accuracy - cfg.allow_accuracy_drop
        ):
            return False, (
                f"accuracy {report.candidate_accuracy:.4f} < live "
                f"{report.live_accuracy:.4f} - {cfg.allow_accuracy_drop:.4f}"
            )
        return True, "gates passed"

    def promote(self, candidate: ServableModel) -> ServableVersion:
        """Install the candidate on the live slot via an atomic swap, with
        the plan the shadow slot measured when the candidate was autotuned,
        and checkpoint the promoted servable when configured."""
        tuned = None
        slot = shadow_slot(self.name)
        if self.config.autotune_candidate and slot in self.engine.models():
            tuned = self.engine.servable(slot).tuned
        stamp = self.engine.swap(self.name, candidate, tuned=tuned)
        if self.ckpt_dir and self.config.checkpoint_promoted:
            from repro_torch.checkpoint.checkpointer import save_servable

            save_servable(self.engine.servable(self.name), self.ckpt_dir, stamp.version)
        return stamp

    def rollback(self) -> ServableVersion:
        """Undo the last promotion on the live slot (instant)."""
        return self.engine.rollback(self.name)

    # --- one full round ---------------------------------------------------

    def run_round(
        self,
        source: DrawSource,
        model: CoTMModel,
        train_ds: TMDataset,
        requests: np.ndarray,
        labels: Optional[np.ndarray] = None,
        *,
        epochs: int = 1,
        state: Optional[PipelineState] = None,
    ) -> Tuple[DrawSource, CoTMModel, PipelineState, ShadowReport]:
        """Train one round, shadow-evaluate, then promote or reject."""
        source, model, state, candidate = self.train_candidate(
            source, model, train_ds, epochs=epochs, state=state
        )
        report = self.shadow_evaluate(candidate, requests, labels)
        ok, report.reason = self.gate(report)
        if ok:
            stamp = self.promote(candidate)
            report.promoted = True
            report.promoted_version = stamp.version
        self.reports.append(report)
        return source, model, state, report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1,
                    help="training epochs per lifecycle round")
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--shadow-requests", type=int, default=256)
    ap.add_argument("--agreement", type=float, default=0.5,
                    help="min prediction agreement to promote (early "
                         "training rounds move predictions a lot)")
    ap.add_argument("--accuracy-drop", type=float, default=0.0,
                    help="max accuracy regression tolerated at promotion")
    ap.add_argument("--autotune", action="store_true",
                    help="autotune each candidate while it shadows")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save every promoted servable (stamp + plan) here")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
    from repro_torch.core.cotm import init_boundary_model
    from repro_torch.core.prng import prng_key
    from repro_torch.data import get_dataset

    cfg = COTM_CONFIGS[args.arch]
    method = BOOLEANIZE_METHOD[args.arch]
    dataset = args.arch.split("-", 1)[1]
    tx, ty, vx, vy, source = get_dataset(
        dataset, n_train=args.n_train, n_test=args.shadow_requests
    )
    # Real datasets come back full-size (the sizes only shape the
    # synthetic fallback); slice to the requested working sets.
    tx, ty = tx[: args.n_train], ty[: args.n_train]
    vx, vy = vx[: args.shadow_requests], vy[: args.shadow_requests]

    trainer = TrainerEngine(cfg, batch_size=args.batch_size, device=args.device)
    train_ds = trainer.prepare(tx, ty, booleanize_method=method)
    engine = ServingEngine(max_batch=args.max_batch, device=trainer.device)
    key = prng_key(args.seed, trainer.device)
    model = init_boundary_model(key, cfg)
    engine.register(args.arch, trainer.freeze_servable(model), booleanize_method=method)
    engine.warmup(args.arch, forms=("raw",))
    print(f"{args.arch}: live v{engine.version_id(args.arch)} ({source} data, "
          f"{train_ds.n} training samples) on {engine.device}")

    driver = LifecycleDriver(
        trainer, engine, args.arch,
        config=LifecycleConfig(
            min_agreement=args.agreement,
            allow_accuracy_drop=args.accuracy_drop,
            shadow_requests=args.shadow_requests,
            autotune_candidate=args.autotune,
        ),
        ckpt_dir=args.ckpt_dir,
        booleanize_method=method,
    )
    state = PipelineState()
    for r in range(args.rounds):
        key, model, state, rep = driver.run_round(
            key, model, train_ds, np.asarray(vx), np.asarray(vy),
            epochs=args.epochs, state=state,
        )
        acc = (f" | acc live {rep.live_accuracy:.4f} -> cand {rep.candidate_accuracy:.4f}"
               if rep.live_accuracy is not None else "")
        verdict = (f"PROMOTED as v{rep.promoted_version}" if rep.promoted
                   else f"rejected ({rep.reason})")
        print(f"round {r}: agreement {rep.agreement:.4f} over {rep.n} mirrored requests "
              f"vs live v{rep.live_version}{acc} | {verdict}")
        if args.autotune:
            at = engine.stats(shadow_slot(args.arch)).autotune
            print(f"round {r}: candidate autotuned in {at.get('total_s', 0.0):.1f}s -> "
                  f"plan {at.get('plan')}")
    print(f"{args.arch}: serving {engine.version(args.arch)}")


if __name__ == "__main__":
    main()
