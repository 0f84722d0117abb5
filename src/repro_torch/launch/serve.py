"""Serve a ConvCoTM with the batched engine, or an LM arch with the
prefill + decode loop, on the card (the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch convcotm-mnist \
        --requests 32 --max-batch 256 [--eval-path fused_sparse] \
        [--ingress host] [--ckpt-dir DIR] [--autotune] [--device cpu]

``--mesh DATA[xMODEL]`` (with ``--shard batch|clause``) serves across a
device mesh (``repro_torch.serve.mesh``): request buckets split over the
"data" axis, optionally the clause pool over "model".  The mesh takes the
first DATA*MODEL CUDA cards, each once, and refuses to start on a machine
with fewer; with ``--device cpu`` (or ``--device cuda:0``) it is that one
device repeated, which runs every meshed code path on one device:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch convcotm-mnist \
        --mesh 2x2 --device cpu --requests 16

``--service`` runs the same model behind the asyncio ``ServingService``
(bounded queue, latency-aware microbatching, graceful drain) under an
open-loop Poisson arrival stream of single-image requests:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch convcotm-mnist \
        --service --rate 2000 --requests 512 --max-delay-us 200 \
        [--submit-form raw|preprocessed|host] [--deadline-s S] \
        [--malformed-frac F] [--abandon-frac F]

The model comes from ``--ckpt-dir`` (either checkpoint flavour, through
``ServingEngine.load_checkpoint``) or is a boundary-initialised ConvCoTM
made from ``--seed``.  Requests are drawn from the arch's test split
(1,024 images; the synthetic glyphs stand in when the IDX files are
absent); accuracy is printed for a restored model.  ``--autotune`` (both
modes) measures the eval-path candidates per request form and bucket at
warmup and serves each bucket from its winner; the plan is printed.

LM archs (``configs.ARCHS``) generate from random prompts on weights drawn
from ``--seed`` (``--reduced`` for the small same-family config), through
:func:`generate`'s cached decode steps; the run prints tokens/s and the
first two rows of tokens:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --batch 4 --prompt-len 32 --gen 16 [--temperature T] [--dtype float32]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        --reduced --device cpu --gen 4
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
from repro_torch.core.cotm import init_boundary_model
from repro_torch.core.prng import prng_key, split
from repro_torch.data import get_dataset
from repro_torch.launch.specs import model_decls
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.paths import available_paths
from repro_torch.sharding.blocks import shard_params
from repro_torch.train.serve_step import decode, sample_tokens

__all__ = ["generate", "parse_serve_mesh", "serve_lm", "serve_tm", "serve_tm_service"]


@torch.no_grad()
def generate(
    cfg,
    params,
    prompt_tokens: torch.Tensor,      # [B, P]
    gen_len: int,
    *,
    mesh=None,
    max_seq: Optional[int] = None,
    temperature: float = 0.0,
    frontend_embeds: Optional[torch.Tensor] = None,
    seed: int = 0,
) -> torch.Tensor:
    """Prompt -> generated tokens [B, gen_len] int32 via cached decode steps,
    on the prompt's device.

    The prompt runs through the decode path token by token (teacher
    forcing), so the cache fills as continuous serving fills it; then each
    sampled token is decoded in turn; with a ``temperature`` each token is
    drawn from the reference's key chain, ``key, k = split(key)`` from
    ``prng_key(seed)``.  ``frontend_embeds`` feed the
    encoder of an encoder-decoder arch.  With a ``mesh`` the parameters
    and the caches are laid out on it once (the caches as the reference's
    ``cache_shardings`` lay them out) and every step runs over its data
    shards (the logits come back to the prompt's device)."""
    b, plen = prompt_tokens.shape
    max_seq = max_seq or (plen + gen_len)
    dev = prompt_tokens.device
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    cross = None
    if cfg.is_encoder_decoder:
        cross = ed.prepare_cross_cache(params, ed.encode(params, frontend_embeds, cfg, mesh=mesh),
                                       cfg, mesh=mesh)
        cache = ed.init_self_cache(b, cfg, max_seq, dev, mesh=mesh)
    else:
        cache = tfm.init_decode_cache(b, cfg, max_seq, dev, mesh=mesh)
    key = prng_key(seed, dev)

    def step(tokens, cache, i):
        logits, cache = decode(params, tokens, cache, i, cfg, cross_cache=cross, mesh=mesh)
        return logits.to(dev), cache

    logits = None
    for i in range(plen):
        logits, cache = step(prompt_tokens[:, i : i + 1], cache, i)

    out = []
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(plen, plen + gen_len):
        key, k = split(key).unbind(0)
        tok, done = sample_tokens(k, logits, temperature=temperature, done=done)
        out.append(tok)
        logits, cache = step(tok[:, None], cache, i)
    return torch.stack(out, dim=1)


def serve_lm(arch: str, *, reduced: bool = False, batch: int = 4, prompt_len: int = 32,
             gen: int = 16, temperature: float = 0.0, dtype: Optional[str] = None,
             seed: int = 0, device=None) -> dict:
    """Generate from random prompts on ``arch`` with weights drawn from
    ``seed``; prints tokens/s and the first two rows of tokens."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    params = init_params(model_decls(cfg), prng_key(seed, dev))
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(dev)
    fe = None
    if cfg.is_encoder_decoder or cfg.modality == "vision":
        fe = torch.from_numpy(rng.standard_normal((batch, 16, cfg.d_model)).astype(np.float32)
                              ).to(device=dev, dtype=cfg.dtype)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, gen, temperature=temperature, frontend_embeds=fe,
                    seed=seed)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.3f}s ({batch * gen / dt:.1f} tok/s) "
          f"on {dev}")
    print(toks.numpy()[:2])
    return {"arch": cfg.name, "device": str(dev), "dtype": str(cfg.dtype), "seconds": dt,
            "tokens_per_s": batch * gen / dt}


def parse_serve_mesh(spec: str | None, shard: str = "batch", device=None):
    """``--mesh`` / ``--shard`` -> :class:`~repro_torch.serve.mesh.ServeMesh`.

    ``spec`` is ``"DATA"`` or ``"DATAxMODEL"`` (``8``, ``4x2``); a bare count
    lands on the axis ``shard`` selects: ``batch`` (the data axis) or
    ``clause`` (the model axis, clause-sharded evaluation).  ``None`` means
    one device, no mesh.  Without ``device`` the mesh takes distinct CUDA
    cards (:func:`~repro_torch.serve.mesh.make_serve_mesh`, which refuses
    too few); with one, that device repeated."""
    if spec is None:
        return None
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve.mesh import ServeMesh, make_serve_mesh

    if "x" in spec:
        data, model = (int(p) for p in spec.split("x", 1))
    elif shard == "clause":
        data, model = 1, int(spec)
    else:
        data, model = int(spec), 1
    shard_clauses = shard == "clause" or model > 1
    if device is None:
        return make_serve_mesh(data, model, shard_clauses=shard_clauses)
    return ServeMesh(make_test_mesh(data, model, device=device), shard_clauses=shard_clauses)


def _tm_engine(arch: str, *, max_batch: int, eval_path: str | None, ckpt_dir: str | None,
               seed: int, device, autotune: bool = False, mesh=None):
    """The engine with ``arch`` registered (restored from ``ckpt_dir``, or a
    seeded boundary model; armed for the autotuner with ``autotune``;
    served across ``mesh``, a ServeMesh, when given) and the test split
    requests are drawn from; returns ``(engine, vx, vy, source)``."""
    cfg = COTM_CONFIGS[arch]
    method = BOOLEANIZE_METHOD[arch]
    dataset = arch.split("-", 1)[1]               # convcotm-mnist -> mnist
    _, _, vx, vy, source = get_dataset(dataset, n_test=1024)
    engine = ServingEngine(max_batch=max_batch, mesh=mesh,
                           device=None if mesh is not None else device, autotune=autotune)
    if mesh is not None:
        print(f'{arch}: serving on a {mesh.n_data}x{mesh.n_model} ("data","model") mesh '
              f"({'clause-sharded' if mesh.shard_clauses else 'replicated'}) of "
              f"{[str(d) for d in mesh.mesh.flat]}")
    if ckpt_dir is not None:
        engine.load_checkpoint(arch, ckpt_dir, cfg, booleanize_method=method, path=eval_path)
        print(f"{arch}: restored model from {ckpt_dir}")
    else:
        model = init_boundary_model(prng_key(seed), cfg)
        engine.register(arch, model, cfg, booleanize_method=method, path=eval_path)
        print(f"{arch}: serving a boundary-initialised model ({source} data)")
    return engine, vx, vy, source


def _print_autotune(engine, arch: str) -> None:
    at = engine.stats(arch).autotune
    print(f"{arch}: autotuned in {at.get('total_s', 0.0):.1f}s -> plan {at.get('plan')}")


def serve_tm(
    arch: str,
    *,
    n_requests: int = 32,
    max_batch: int = 256,
    eval_path: str | None = "fused",
    ckpt_dir: str | None = None,
    seed: int = 0,
    ingress: str = "device",
    device=None,
    autotune: bool = False,
    mesh=None,
) -> dict:
    """Warm every bucket (tuning first with ``autotune``), then serve
    ``n_requests`` requests of 1..max_batch test images through
    ``classify`` (``ingress='host'`` replays the host pipeline), across
    ``mesh`` (a ServeMesh, see :func:`parse_serve_mesh`) when given;
    returns the engine's statistics."""
    engine, vx, vy, source = _tm_engine(arch, max_batch=max_batch, eval_path=eval_path,
                                        ckpt_dir=ckpt_dir, seed=seed, device=device,
                                        autotune=autotune, mesh=mesh)
    warmed = engine.warmup(arch)
    print(f"{arch}: on {engine.device} ({engine.resolved_path(arch)} path); warmed "
          f"buckets {list(warmed)}")
    if autotune:
        _print_autotune(engine, arch)
    rng = np.random.default_rng(seed)
    correct = total = 0
    for _ in range(n_requests):
        n = int(rng.integers(1, max_batch + 1))
        idx = rng.integers(0, len(vx), n)
        res = engine.classify(arch, vx[idx], ingress=ingress)
        correct += int((res.predictions == vy[idx].astype(np.int64)).sum())
        total += n
    st = engine.stats(arch)
    print(
        f"{arch}: {st.images} images in {st.requests} requests | "
        f"{st.classifications_per_s:,.0f} classifications/s | "
        f"mean latency {st.mean_latency_us:,.0f} us (ingress "
        f"{st.mean_ingress_us:,.0f} + device {st.mean_device_us:,.0f}) | "
        f"bucket hits {dict(sorted(st.bucket_hits.items()))}"
    )
    if ckpt_dir is not None:
        print(f"{arch}: accuracy {correct / total:.4f} on {source} test data")
    return st.as_dict()


async def serve_tm_service(
    arch: str,
    *,
    n_requests: int = 256,
    rate: float = 2000.0,
    max_batch: int = 256,
    max_delay_us: float = 200.0,
    high_water: int = 4096,
    eval_path: str | None = "fused",
    ckpt_dir: str | None = None,
    seed: int = 0,
    submit_form: str = "raw",
    deadline_s: float | None = None,
    malformed_frac: float = 0.0,
    abandon_frac: float = 0.0,
    device=None,
    autotune: bool = False,
    mesh=None,
) -> dict:
    """Drive the async ``ServingService`` with open-loop Poisson arrivals
    of single-image requests at ``rate`` req/s, then drain gracefully;
    returns the service's statistics.

    ``submit_form``: ``'raw'`` pixels (ingress on the device, once per
    microbatch), ``'preprocessed'`` (the pool preprocessed once up front,
    so the run measures the service spine alone) or ``'host'`` (the
    per-request host ingress).  ``deadline_s`` stamps every request,
    ``malformed_frac`` corrupts that fraction of submissions (refused at
    validation) and ``abandon_frac`` models clients that stop waiting;
    every admitted future still resolves.  ``autotune`` tunes at warmup;
    ``mesh`` (a ServeMesh) serves across a device mesh.
    """
    from repro_torch.serve.loadgen import poisson_open_loop
    from repro_torch.serve.service import ServiceConfig, ServingService

    if submit_form not in ("raw", "preprocessed", "host"):
        raise ValueError(f"unknown submit_form {submit_form!r}")
    engine, vx, vy, source = _tm_engine(arch, max_batch=max_batch, eval_path=eval_path,
                                        ckpt_dir=ckpt_dir, seed=seed, device=device,
                                        autotune=autotune, mesh=mesh)
    engine.warmup(arch)
    if autotune:
        _print_autotune(engine, arch)
    pool = engine.preprocess(arch, vx) if submit_form == "preprocessed" else np.asarray(vx)

    service = ServingService(engine, ServiceConfig(max_delay_us=max_delay_us,
                                                   high_water=high_water))
    await service.start()
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(vx), n_requests)
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    report = await poisson_open_loop(
        service, arch, [pool[j : j + 1] for j in idx], rate, seed=seed,
        preprocessed=submit_form == "preprocessed", host_ingress=submit_form == "host",
        deadline_s=deadline_s, malformed_frac=malformed_frac, abandon_frac=abandon_frac,
    )
    admitted = report.admitted
    # Abandoned futures resolve too; with a deadline some resolve as
    # ServiceExpired.
    outcomes = await asyncio.gather(*(f for _, f in admitted + report.abandoned),
                                    return_exceptions=True)
    await service.stop(drain=True)
    wall = loop.time() - t0

    st = service.stats(arch)
    print(
        f"{arch}: offered {n_requests / wall:,.0f} req/s | completed {st.completed} "
        f"({st.completed / wall:,.0f}/s), rejected {report.rejected} | "
        f"p50 {st.p50_latency_us:,.0f} us p99 {st.p99_latency_us:,.0f} us | "
        f"split ingress {st.ingress_us_per_image:,.0f} / device "
        f"{st.device_us_per_image:,.0f} us/img | mean occupancy {st.mean_occupancy:.2f} | "
        f"occupancy hist {st.occupancy_hist}"
    )
    print(
        f"{arch}: queue wait p50 {st.p50_queue_wait_us:,.0f} us p99 "
        f"{st.p99_queue_wait_us:,.0f} us | per microbatch: dispatch thread "
        f"{st.dispatch_us_per_batch:,.0f} us, completion thread "
        f"{st.complete_us_per_batch:,.0f} us | collections by generation "
        f"{st.gc_collections}, pauses {[round(p) for p in st.gc_pause_us]} us, longest "
        f"gen-2 {st.gc_max_gen2_pause_us:,.0f} us"
    )
    health = service.health()
    print(f"{arch}: health {health.state}, path {engine.resolved_path(arch)}, "
          f"fallback_path {health.fallback_path}, dispatch failures "
          f"{health.dispatch_failures}")
    if deadline_s is not None or malformed_frac or abandon_frac:
        print(f"{arch}: faults — expired {st.expired}, malformed {report.malformed}, "
              f"abandoned {len(report.abandoned)} (all resolved)")
    results = [(i, r) for (i, _), r in zip(admitted, outcomes)
               if not isinstance(r, BaseException)]
    if ckpt_dir is not None and results:
        correct = sum(int(r.predictions[0]) == int(vy[idx[i]]) for i, r in results)
        print(f"{arch}: accuracy {correct / len(results):.4f} on {source} test data")
    return st.as_dict()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(COTM_CONFIGS) + list_archs())
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--eval-path", default="fused", choices=available_paths())
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest checkpoint here (a trainer's model or a "
                         "save_servable image)")
    ap.add_argument("--ingress", default="device", choices=["device", "host"],
                    help="raw-request ingress: on the device, or the host pipeline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--autotune", action="store_true",
                    help="measure the eval-path candidates per form and bucket at "
                         "warmup and serve each bucket from its winner")
    ap.add_argument("--mesh", default=None, metavar="DATA[xMODEL]",
                    help="serve across a device mesh, e.g. 4 (data-parallel) or 2x2 "
                         "(batch over 2, clauses over 2); needs DATA*MODEL CUDA cards, "
                         "or with --device one device repeated")
    ap.add_argument("--shard", default="batch", choices=["batch", "clause"],
                    help="which axis a bare --mesh count shards: request batches over "
                         "\"data\" or the clause pool over \"model\"")
    ap.add_argument("--service", action="store_true",
                    help="serve through the asyncio ServingService")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="Poisson arrival rate, requests/s (--service)")
    ap.add_argument("--max-delay-us", type=float, default=200.0,
                    help="microbatch coalescing deadline (--service)")
    ap.add_argument("--high-water", type=int, default=4096,
                    help="queued-image admission limit (--service)")
    ap.add_argument("--submit-form", default="raw", choices=["raw", "preprocessed", "host"],
                    help="request form of --service submissions")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds (--service); requests "
                         "past it are shed with ServiceExpired before dispatch")
    ap.add_argument("--malformed-frac", type=float, default=0.0,
                    help="fraction of submissions shape-corrupted, to be refused at "
                         "validation (--service)")
    ap.add_argument("--abandon-frac", type=float, default=0.0,
                    help="fraction of admitted requests whose client walks away; "
                         "their futures still resolve (--service)")
    ap.add_argument("--reduced", action="store_true",
                    help="LM archs: the small same-family config")
    ap.add_argument("--batch", type=int, default=4, help="LM archs: prompts per batch")
    ap.add_argument("--prompt-len", type=int, default=32, help="LM archs: prompt tokens")
    ap.add_argument("--gen", type=int, default=16, help="LM archs: tokens to generate")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="LM archs: sampling temperature (0: greedy)")
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="LM archs: weight and activation dtype (default: the config's)")
    args = ap.parse_args(argv)
    if args.arch not in COTM_CONFIGS:
        stats = serve_lm(args.arch, reduced=args.reduced, batch=args.batch,
                         prompt_len=args.prompt_len, gen=args.gen,
                         temperature=args.temperature, dtype=args.dtype, seed=args.seed,
                         device=args.device)
        print(json.dumps(stats))
        return
    common = dict(max_batch=args.max_batch, eval_path=args.eval_path,
                  ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device,
                  autotune=args.autotune,
                  mesh=parse_serve_mesh(args.mesh, args.shard, args.device))
    if args.service:
        stats = asyncio.run(serve_tm_service(
            args.arch, n_requests=args.requests, rate=args.rate,
            max_delay_us=args.max_delay_us, high_water=args.high_water,
            submit_form=args.submit_form, deadline_s=args.deadline_s,
            malformed_frac=args.malformed_frac, abandon_frac=args.abandon_frac, **common,
        ))
    else:
        stats = serve_tm(args.arch, n_requests=args.requests, ingress=args.ingress, **common)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
