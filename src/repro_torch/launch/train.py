"""Train a ConvCoTM on the card (TM part of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch convcotm-mnist \
        --epochs 2 [--batch 100] [--mode batch] [--ckpt-dir DIR] [--device cpu]

The dataset is the arch's (MNIST, FMNIST or KMNIST in IDX form under
``$REPRO_DATA_DIR``), or the synthetic glyphs when those files are
absent.  Training runs through ``train.tm_engine.TrainerEngine``: the
dataset's literals frozen once on the device, one draw generator on the
same device seeded from ``--seed``, a checkpoint (model, cursor,
generator state) after every epoch.  A restarted run resumes from the
newest checkpoint and finishes the requested epochs with the draws an
uninterrupted run would have used; a checkpoint written with another
batch size, mode or seed, or on another device type (whose generator
draws other numbers), is refused.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step, restore_pytree
from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
from repro_torch.data import PipelineState, get_dataset
from repro_torch.train.tm_engine import TrainerEngine

__all__ = ["run_tm_training"]


def _generator_state(extra: Dict, gen: torch.Generator, device: torch.device,
                     ckpt_dir: str) -> torch.Tensor:
    """The saved draw-generator state, if ``gen`` can take it.  A CUDA and
    a CPU generator keep different states and draw different numbers, so a
    checkpoint written on another device type is refused.  A checkpoint
    that names no device is taken only when its state has the length of
    ``gen``'s."""
    state = torch.tensor(extra["generator"], dtype=torch.uint8)
    saved = extra.get("generator_device")
    if saved is None and state.numel() == gen.get_state().numel():
        return state
    if saved != device.type:
        raise ValueError(
            f"checkpoint at {ckpt_dir} holds the draw generator of a "
            f"{saved or 'different'} device; resuming on {device.type} would break "
            f"the draw sequence: resume on {saved or 'the device it was trained on'} "
            f"or use a fresh directory"
        )
    return state


def run_tm_training(
    arch: str,
    *,
    epochs: int = 5,
    batch: int = 100,
    mode: str = "batch",
    n_train: int = 4000,
    n_test: int = 800,
    ckpt_dir: str | None = None,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Train ``arch`` up to ``epochs`` epochs in all (resuming from
    ``ckpt_dir`` when it holds a checkpoint); returns the last epoch's
    accuracy and samples/s, and the epoch count reached."""
    cfg = COTM_CONFIGS[arch]
    method = BOOLEANIZE_METHOD[arch]
    dataset = arch.split("-", 1)[1]               # convcotm-mnist -> mnist
    tx, ty, vx, vy, source = get_dataset(dataset, n_train=n_train, n_test=n_test)
    engine = TrainerEngine(cfg, batch_size=batch, mode=mode, device=device)
    print(f"{arch}: dataset source {source} ({len(tx)} train / {len(vx)} test) on "
          f"{engine.device}")
    train_ds = engine.prepare(tx, ty, booleanize_method=method)
    eval_ds = engine.prepare(vx, vy, booleanize_method=method)

    gen = engine.draws_generator(seed)
    model = engine.init_model(torch.Generator().manual_seed(seed))
    state = PipelineState(seed=seed)
    trainer_meta = {"batch_size": batch, "mode": mode, "seed": seed}
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        model, step, extra = restore_pytree(model, ckpt_dir, device=engine.device)
        saved = extra.get("trainer")
        if saved != trainer_meta:
            # Another batch size, mode or seed changes the steps per epoch
            # and the draws: the run would match no uninterrupted run.
            raise ValueError(
                f"checkpoint at {ckpt_dir} was trained with {saved}; resuming with "
                f"{trainer_meta} would break the draw sequence: restart with "
                f"matching flags or a fresh directory"
            )
        state = PipelineState.from_dict(extra["pipeline"])
        gen.set_state(_generator_state(extra, gen, engine.device, ckpt_dir))
        print(f"{arch}: resumed from epoch {state.epoch} (step {step})")

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    reports = []
    while state.epoch < epochs:
        gen, model, state, reps = engine.fit(
            gen, model, train_ds, epochs=1, eval_ds=eval_ds, state=state,
            log=lambda s: print(f"{arch}: {s}"),
        )
        reports.extend(reps)
        if ckpt:
            ckpt.save(model, state.epoch, extra={
                "pipeline": state.as_dict(),
                "generator": gen.get_state().tolist(),
                "generator_device": gen.device.type,
                "trainer": trainer_meta,
            })
    if ckpt:
        ckpt.wait()
    if not reports:
        print(f"{arch}: checkpoint already at epoch {state.epoch} >= {epochs}")
        return {"accuracy": engine.evaluate(model, eval_ds), "samples_per_s": 0.0,
                "epochs": float(state.epoch)}
    last = reports[-1]
    return {
        "accuracy": last.accuracy if last.accuracy is not None else float("nan"),
        "samples_per_s": last.samples_per_s,
        "epochs": float(state.epoch),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(COTM_CONFIGS))
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--mode", default="batch", choices=["batch", "scan"])
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-test", type=int, default=800)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' trains on the CPU)")
    args = ap.parse_args(argv)
    out = run_tm_training(
        args.arch, epochs=args.epochs, batch=args.batch, mode=args.mode,
        n_train=args.n_train, n_test=args.n_test, ckpt_dir=args.ckpt_dir,
        seed=args.seed, device=args.device,
    )
    print(f"final: acc {out['accuracy']:.4f} {out['samples_per_s']:,.0f} samples/s")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
