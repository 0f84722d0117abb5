"""Train an LM arch or a ConvCoTM (the port's ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        [--reduced] --steps 20 [--batch 8] [--seq 128] [--microbatches 2] \
        [--ckpt-dir DIR] [--grad-compression] [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.train --arch convcotm-mnist \
        --epochs 2 [--batch 100] [--mode batch] [--ckpt-dir DIR] [--device cpu]

LM archs: the model drawn from ``prng_key(seed)`` as the reference draws
it (so the card, the CPU and the reference start from the same weights),
the train step
(``train.train_step``) on the run's device over the learnable synthetic
token stream, a checkpoint of the whole train state in the reference's
layout every ``checkpoint_every`` steps and at the end, and a straggler
verdict per step.  A restarted run resumes from the newest checkpoint,
written by either package.  ``run_training`` takes a ``mesh``, as the
reference's does: the state is laid out on it and the step runs over its
data shards (``train.train_step``); the command line, like the
reference's, trains on one device.

ConvCoTM archs: the dataset is the arch's (MNIST, FMNIST or KMNIST in IDX
form under ``$REPRO_DATA_DIR``), or the synthetic glyphs when those files
are absent.  Training runs through ``train.tm_engine.TrainerEngine``: the
dataset's literals frozen once on the device, the model and the draws
from ``prng_key(--seed)`` as the reference's launcher takes them, a
checkpoint (model, cursor, the key as the reference's ``uint32[2]``)
after every epoch.  A restarted run resumes from the newest checkpoint,
written by either package on any device, and finishes the requested
epochs with the draws an uninterrupted run would have used; a checkpoint
written with another batch size, mode or seed is refused.

Both run on the CUDA card unless ``--device`` names another device; with
no card and no ``--device`` they raise.
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step, restore_pytree
from repro_torch.configs import ARCHS, TrainConfig, get_config, reduced_config
from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
from repro_torch.convert import lm_state_from_arrays, lm_state_to_arrays
from repro_torch.core.prng import key_data, key_from_data, prng_key
from repro_torch.data import PipelineState, get_dataset
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.launch.specs import abstract_model, model_decls
from repro_torch.models.base import init_params, param_count
from repro_torch.sharding.blocks import BlockStore
from repro_torch.train.tm_engine import TrainerEngine
from repro_torch.train.train_step import (
    gather_train_state,
    init_train_state,
    make_train_step,
    shard_train_state,
)

__all__ = ["run_tm_training", "run_training", "state_template", "synthetic_lm_batch"]


def _token_stream(rng, batch: int, seq: int, vocab: int, noise: float = 0.05) -> np.ndarray:
    """A learnable synthetic stream, int32 ``[batch, seq]``: ascending runs
    (the successor rule with random restarts) plus noise; uniform tokens
    would put the loss floor at ln(V) and nothing could train.  The
    reference's draws, in its order."""
    starts = rng.integers(0, vocab, batch)
    ramp = starts[:, None] + np.arange(seq)[None, :]
    restart = rng.random((batch, seq)) < 0.02
    offsets = np.cumsum(restart * rng.integers(1, vocab, (batch, seq)), axis=1)
    toks = (ramp + offsets) % vocab
    flip = rng.random((batch, seq)) < noise
    toks = np.where(flip, rng.integers(0, vocab, (batch, seq)), toks)
    return toks.astype(np.int32)


def synthetic_lm_batch(cfg, batch: int, seq: int, step: int, device=None) -> Dict[str, Any]:
    """The deterministic batch of ``step`` (numpy seeded ``1234 + step``, the
    reference's draws), as tensors on ``device`` (the card unless ``"cpu"``
    is named): ``tokens``; a vision arch's ``frontend_embeds`` in place of
    its first ``max(seq // 4, 4)`` tokens; an encoder-decoder's frame
    ``frontend_embeds`` and ``max(seq // 4, 16)`` ``dec_tokens``."""
    device = resolve_device(device)
    rng = np.random.default_rng(1234 + step)

    def embeds(n):
        return torch.from_numpy(rng.standard_normal((batch, n, cfg.d_model))).to(
            device=device, dtype=cfg.dtype)

    def tokens(n):
        return torch.from_numpy(_token_stream(rng, batch, n, cfg.vocab_size)).to(device)

    if cfg.is_encoder_decoder:
        return {"frontend_embeds": embeds(seq), "dec_tokens": tokens(max(seq // 4, 16))}
    out = {"tokens": tokens(seq)}
    if cfg.modality == "vision":
        nv = max(seq // 4, 4)
        out["tokens"] = out["tokens"][:, : seq - nv]
        out["frontend_embeds"] = embeds(nv)
    return out


def state_template(cfg, tcfg: TrainConfig) -> Dict[str, Any]:
    """The train state of ``cfg`` in the reference's layout as meta
    tensors: the shapes and dtypes a checkpoint restore needs, no memory."""
    return lm_state_to_arrays(init_train_state(abstract_model(cfg), tcfg), cfg)


def _host_peak_gib() -> float:
    """This process's peak resident host memory so far, GiB (Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _save(ckpt: Checkpointer, state, cfg, step: int) -> None:
    """Hand ``ckpt`` one fresh host copy of the state (no second copy; a
    meshed state is gathered whole first)."""
    t0 = time.time()
    if isinstance(state["params"], BlockStore):
        state = gather_train_state(state)
    ckpt.save(lm_state_to_arrays(state, cfg), step, fresh=True)
    print(f"checkpoint step {step}: host copy {time.time() - t0:.2f}s, "
          f"host peak {_host_peak_gib():.2f} GiB")


def run_training(
    cfg,
    tcfg: TrainConfig,
    mesh=None,
    *,
    device=None,
    batch: int,
    seq: int,
    steps: int,
    ckpt_dir: str | None = None,
    log_every: int = 5,
    batch_fn=None,
) -> Dict[str, float]:
    """Train ``cfg`` up to ``steps`` steps in all on ``device`` (the card
    unless ``"cpu"`` is named), resuming from ``ckpt_dir`` when it holds a
    checkpoint.  With a ``mesh`` the state is laid out on it (the batches
    are made on ``device``, the mesh's first device by default).  Returns
    the last step's metrics as floats and ``first_loss``, the loss of the
    first step this run took."""
    if mesh is not None and device is None:
        device = mesh.flat[0]
    device = resolve_device(device)
    batch_fn = batch_fn or (lambda step: synthetic_lm_batch(cfg, batch, seq, step, device))
    step_fn = make_train_step(cfg, tcfg, mesh)

    start = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and latest_step(ckpt_dir) is not None:
        # Shapes from the meta device; the host arrays go to the device
        # leaf by leaf, and no fresh state is drawn beside them.
        t0 = time.time()
        tree, start, _ = ckpt.restore(state_template(cfg, tcfg), device="cpu")
        state = lm_state_from_arrays(cfg, tree, device=device)
        del tree
        saved = start
        print(f"resumed from step {start}")
        print(f"checkpoint step {start}: restored in {time.time() - t0:.2f}s, "
              f"host peak {_host_peak_gib():.2f} GiB")
    else:
        saved = None
        params = init_params(model_decls(cfg), prng_key(tcfg.seed, device), device)
        state = init_train_state(params, tcfg)
    if mesh is not None:
        state = shard_train_state(state, cfg, mesh)

    policy = StragglerPolicy()
    metrics: Dict[str, Any] = {}
    first_loss = None
    for step in range(start, steps):
        t0 = time.time()
        state, metrics = step_fn(state, batch_fn(step))
        loss = float(metrics["loss"])              # waits for the step
        if first_loss is None:
            first_loss = loss
        dt = time.time() - t0
        verdict = policy.observe(dt)
        if verdict != "ok":
            print(f"[straggler-policy] step {step}: {verdict} ({dt:.2f}s)")
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt:.2f}s")
        if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
            _save(ckpt, state, cfg, step + 1)
            saved = step + 1
    if ckpt:
        if saved != steps:                    # the last step is saved once
            _save(ckpt, state, cfg, steps)
        t0 = time.time()
        ckpt.wait()
        if start < steps:
            print(f"checkpoint step {steps}: written {time.time() - t0:.2f}s after its host copy")
    out = {k: float(v) for k, v in metrics.items()}
    out["first_loss"] = first_loss if first_loss is not None else float("nan")
    return out


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

    key = prng_key(seed, engine.device)
    model = engine.init_model(key)
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
        key = key_from_data(extra["key"], engine.device)
        print(f"{arch}: resumed from epoch {state.epoch} (step {step})")

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    reports = []
    while state.epoch < epochs:
        key, model, state, reps = engine.fit(
            key, model, train_ds, epochs=1, eval_ds=eval_ds, state=state,
            log=lambda s: print(f"{arch}: {s}"),
        )
        reports.extend(reps)
        if ckpt:
            ckpt.save(model, state.epoch, extra={
                "pipeline": state.as_dict(),
                "key": key_data(key).tolist(),
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
    ap.add_argument("--arch", required=True, choices=sorted(COTM_CONFIGS) + sorted(ARCHS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' trains on the CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    # per-arch default resolved after parsing: 8 for an LM, 100 for a ConvCoTM
    ap.add_argument("--batch", type=int, default=None)
    # LM flags
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    # ConvCoTM (TrainerEngine) flags
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--mode", default="batch", choices=["batch", "scan"])
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-test", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.arch in COTM_CONFIGS:
        out = run_tm_training(
            args.arch, epochs=args.epochs,
            batch=args.batch if args.batch is not None else 100, mode=args.mode,
            n_train=args.n_train, n_test=args.n_test, ckpt_dir=args.ckpt_dir,
            seed=args.seed, device=args.device,
        )
        print(f"final: acc {out['accuracy']:.4f} {out['samples_per_s']:,.0f} samples/s")
        print(json.dumps(out))
        return

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 10, 1),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        checkpoint_every=max(args.steps // 2, 1),
        seed=args.seed,
    )
    device = resolve_device(args.device)
    n = param_count(model_decls(cfg))
    print(f"arch={cfg.name} params={n/1e6:.1f}M device={device}")
    out = run_training(
        cfg, tcfg, device=device,
        batch=args.batch if args.batch is not None else 8,
        seq=args.seq, steps=args.steps, ckpt_dir=args.ckpt_dir,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
