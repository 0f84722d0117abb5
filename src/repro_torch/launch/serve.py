"""Serve a ConvCoTM on the card with the batched engine (TM part of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch convcotm-mnist \
        --requests 32 --max-batch 256 [--eval-path fused_sparse] [--device cpu]

The model is a boundary-initialised ConvCoTM made from ``--seed`` (no
trained weights ship with the repo), and the requests are random raw
uint8 images of mixed sizes from the same seed: enough to drive the
whole raw -> predictions path and measure throughput, not accuracy.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
from repro_torch.core.cotm import init_boundary_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.paths import available_paths

__all__ = ["serve_tm"]


def serve_tm(
    arch: str,
    *,
    n_requests: int = 32,
    max_batch: int = 256,
    eval_path: str = "fused",
    seed: int = 0,
    device=None,
) -> dict:
    """Register a seeded boundary model of ``arch``, warm every bucket, and
    serve ``n_requests`` requests of 1..max_batch random images; returns
    the engine's statistics."""
    cfg = COTM_CONFIGS[arch]
    engine = ServingEngine(max_batch=max_batch, device=device)
    model = init_boundary_model(torch.Generator().manual_seed(seed), cfg)
    engine.register(arch, model, cfg, booleanize_method=BOOLEANIZE_METHOD[arch],
                    path=eval_path)
    warmed = engine.warmup(arch)
    print(f"{arch}: serving a boundary-initialised model on {engine.device} "
          f"({engine.resolved_path(arch)} path); warmed buckets {list(warmed)}")
    rng = np.random.default_rng(seed)
    shape = (cfg.patch.image_y, cfg.patch.image_x)
    for _ in range(n_requests):
        n = int(rng.integers(1, max_batch + 1))
        engine.classify(arch, rng.integers(0, 256, (n,) + shape, dtype=np.uint8))
    st = engine.stats(arch)
    print(
        f"{arch}: {st.images} images in {st.requests} requests | "
        f"{st.classifications_per_s:,.0f} classifications/s | "
        f"mean latency {st.mean_latency_us:,.0f} us (ingress "
        f"{st.mean_ingress_us:,.0f} + device {st.mean_device_us:,.0f}) | "
        f"bucket hits {dict(sorted(st.bucket_hits.items()))}"
    )
    return st.as_dict()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(COTM_CONFIGS))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--eval-path", default="fused", choices=available_paths())
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    stats = serve_tm(
        args.arch, n_requests=args.requests, max_batch=args.max_batch,
        eval_path=args.eval_path, seed=args.seed, device=args.device,
    )
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
