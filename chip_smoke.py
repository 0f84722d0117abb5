#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card: build, check, serve, time.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch`` beside
this file and builds the CUDA kernels from ``src/repro_torch/csrc``).

  1. environment: the card's name and power limit (``nvidia-smi``), the
     torch and CUDA versions, and the kernels' build time;
  2. each CUDA kernel against its plain PyTorch version on the card,
     ``torch.equal`` after a synchronise (every output is an integer):
     the ingress kernel over four geometries, the fused kernel over the
     reference's kernel sweep with CSRF on and off, both density
     extremes, a saturating pool and the envelope corner;
  3. the main path: ``ServingEngine.register`` -> ``classify`` of the
     ``convcotm-mnist`` configuration (full width, boundary-initialised
     weights from a seed) on the ``fused`` path, requests of 1, 3, 64,
     256 and 300 images; launch counters set to 0 just before and read
     just after; results equal to the engine's ``dense`` path on the card
     and to the plain composition on the CPU;
  4. times at bucket 256 with CUDA events (median of repeats after
     warm-up): each kernel and its plain version beside the least time
     the card could take, classify throughput at bucket 256 and latency
     at bucket 1; then one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises and exits non-zero, as does a run without CUDA or outside the
repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: 32-bit rate outside the tensor cores, used as the integer-op ceiling.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, *, inner: int, repeats: int = 11, warmup: int = 3) -> float:
    """Median milliseconds per call of ``fn`` on the card: ``repeats``
    windows of ``inner`` back-to-back calls between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_word_tests(lit, inc, ne) -> int:
    """Word tests these inputs need: for each image and nonempty clause, on
    every patch up to its first firing patch, the words up to and
    including the first violated one (all W on the patch that fires)."""
    import torch

    from repro_torch.core.clauses import patch_chunk

    b, p, w = lit.shape
    c = inc.shape[0]
    alive = ne.to(torch.bool)[None, :].expand(b, c).clone()
    total = 0
    step = patch_chunk(b, c, w, p)
    for p0 in range(0, p, step):
        viol = (inc[None, None] & ~lit[:, p0 : p0 + step, None, :]) != 0   # [B,Pc,C,W]
        anyv = viol.any(-1)
        words = torch.where(anyv, viol.to(torch.int32).argmax(-1) + 1, w)
        fires = (~anyv).to(torch.int32)
        not_yet = (fires.cumsum(1) - fires) == 0       # no fire earlier in this chunk
        total += int((words * (alive[:, None, :] & not_yet)).sum())
        alive &= ~(~anyv).any(1)
    return total


def profile_classify(engine, arch: str, imgs, reps: int, label: str) -> None:
    """Where a classify's time goes: ``torch.profiler`` over ``reps``
    requests; prints the device's busy share of the wall time (kernels,
    copies) and the operations with the most device and host self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.classify(arch, imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            engine.classify(arch, imgs)
        wall_us = (time.perf_counter() - t) * 1e6
    rows = prof.key_averages()

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    busy = sum(dev_us(e) for e in rows)
    if not busy:
        print(f"[profile] {label}: the profiler captured no device time (not measured)")
        return
    copies = sum(dev_us(e) for e in rows if "memcpy" in e.key.lower())
    print(f"[profile] {label}: {reps} requests, wall {wall_us / reps:.1f} us/request, "
          f"device busy {busy / reps:.1f} us/request ({100 * busy / wall_us:.1f}% of wall; "
          f"copies {copies / reps:.1f} us), idle {100 * (1 - busy / wall_us):.1f}%")
    for e in sorted(rows, key=dev_us, reverse=True)[:8]:
        if dev_us(e):
            print(f"[profile] {label}: device {dev_us(e) / reps:9.2f} us/request "
                  f"x{e.count // reps:<3d} {e.key[:80]}")
    for e in sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"[profile] {label}: host {e.self_cpu_time_total / reps:9.2f} us/request "
              f"x{e.count // reps:<3d} {e.key[:80]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    import numpy as np

    from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
    from repro_torch.core.booleanize import threshold_booleanize
    from repro_torch.core.cotm import init_boundary_model
    from repro_torch.core.patches import PatchSpec, pack_bits
    from repro_torch.kernels import _build, ops, registry
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.servable import freeze

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- 1. environment and build ------------------------------------------
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t
    print(f"[env] built {list(_build.SOURCES)} in {build_s:.2f} s")
    for name, log in _build.PTXAS_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    # --- 2. kernels against their plain versions ----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_bits(shape, p_one):
        return (torch.rand(shape, generator=gen, device=dev) < p_one).to(torch.uint8)

    ingress_specs = {
        "paper": PatchSpec(),
        "noisy_xor": PatchSpec(image_x=4, image_y=4, window_x=2, window_y=2),
        "stride2": PatchSpec(image_x=12, image_y=12, window_x=4, window_y=4,
                             stride_x=2, stride_y=2),
        "whole_image": PatchSpec(image_x=11, image_y=9, window_x=11, window_y=9),
    }
    for name, spec in ingress_specs.items():
        for b in (1, 5, 256):
            imgs = rand_bits((b, spec.image_y, spec.image_x), 0.4)
            got = ops.ingress_pack(imgs, spec)
            want = ops.ingress_pack(imgs, spec, backend="plain")
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"ingress_pack differs from plain: {name} B={b}")
        print(f"[kernel] ingress_pack == plain: {name} (B=1,5,256)")

    def fused_inputs(b, p, c, nlit, m=10, include_p=None, lit_p=0.5):
        lits = pack_bits(rand_bits((b, p, nlit), lit_p))
        if include_p is None:        # a spread of include densities per clause
            q = torch.logspace(-4, -0.3, c, device=dev)[
                torch.randperm(c, generator=gen, device=dev)]
            inc = (torch.rand((c, nlit), generator=gen, device=dev) < q[:, None])
        else:
            inc = torch.rand((c, nlit), generator=gen, device=dev) < include_p
        inc = inc.to(torch.uint8)
        inc[0] = 0                                       # one empty clause
        ne = inc.any(dim=1)
        w = torch.randint(-127, 128, (m, c), generator=gen, device=dev, dtype=torch.int32)
        return lits, pack_bits(inc), ne, w

    fused_cases = {f"{b}x{p}x{c}x{n}": (b, p, c, n, {}) for b, p, c, n in
                   [(4, 361, 128, 272), (1, 9, 16, 16), (3, 50, 70, 100),
                    (8, 64, 256, 512), (2, 361, 1000, 272)]}
    fused_cases["density0.0"] = (2, 30, 64, 128, dict(include_p=1.0))
    fused_cases["density1.0"] = (2, 30, 64, 128, dict(include_p=0.0))
    fused_cases["saturating"] = (4, 361, 300, 272, dict(include_p=0.002, lit_p=1.0))
    fused_cases["envelope"] = (2, 2048, 1024, 8192, dict(m=64))
    for name, (b, p, c, n, kw) in fused_cases.items():
        args = fused_inputs(b, p, c, n, **kw)
        want = ops.fused_infer(*args, backend="plain")
        for csrf in (True, False):
            got = ops.fused_infer(*args, csrf=csrf)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"fused_infer differs from plain: {name} csrf={csrf}")
        print(f"[kernel] fused_infer == plain: {name} (csrf on, off)")

    # --- 3. the main path: the engine on convcotm-mnist ----------------------
    arch = "convcotm-mnist"
    cfg = COTM_CONFIGS[arch]
    method = BOOLEANIZE_METHOD[arch]
    model = init_boundary_model(torch.Generator().manual_seed(SEED), cfg)
    engine = ServingEngine(max_batch=256)
    engine.register(arch, model, cfg, booleanize_method=method, path="fused")
    engine.register(f"{arch}/dense", model, cfg, booleanize_method=method, path="dense")
    check(engine.device.type == "cuda", f"engine runs on {engine.device}")
    engine.warmup(arch)
    rng = np.random.default_rng(SEED)
    sizes = (1, 3, 64, 256, 300)
    requests = [rng.integers(0, 256, (n, 28, 28), dtype=np.uint8) for n in sizes]

    registry.reset_launches()
    fused = [engine.classify(arch, r) for r in requests]
    launches = registry.launch_counts()
    print(f"[engine] launches during classify on the fused path: {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    cpu = ServingEngine(max_batch=256, device="cpu")
    cpu.register(arch, model, cfg, booleanize_method=method, path="fused")
    for n, r, res in zip(sizes, requests, fused):
        check(res.predictions.shape == (n,) and res.class_sums.shape == (n, cfg.n_classes),
              f"request of {n}: shapes {res.predictions.shape} {res.class_sums.shape}")
        check(res.predictions.dtype == np.int32 and res.class_sums.dtype == np.int32,
              "results are not int32")
        check(bool(((res.predictions >= 0) & (res.predictions < cfg.n_classes)).all()),
              "prediction out of range")
        check(np.array_equal(res.predictions, res.class_sums.argmax(axis=1)),
              "predictions are not the first argmax of the class sums")
        dense = engine.classify(f"{arch}/dense", r)
        plain = cpu.classify(arch, r)
        for other, label in ((dense, "dense path on the card"),
                             (plain, "plain composition on the CPU")):
            check(np.array_equal(res.predictions, other.predictions)
                  and np.array_equal(res.class_sums, other.class_sums),
                  f"request of {n}: fused path differs from the {label}")
        print(f"[engine] request of {n}: fused == dense (card) == plain (CPU); "
              f"bucket {res.bucket}; classes seen {sorted(set(res.predictions.tolist()))}")

    # A boundary model includes about half its literals, so no clause fires
    # on any image and every class sum is 0.  A pool with a few includes per
    # clause, as trained pools have, fires: check that nonzero sums agree too.
    g = torch.Generator().manual_seed(SEED + 1)
    few = torch.rand(tuple(model.ta_state.shape), generator=g) < 3.0 / cfg.n_literals
    sparse_model = type(model)(
        ta_state=torch.where(few, 133, 123).to(torch.uint8), weights=model.weights.clone())
    for label, path, eng in (("fused", "fused", engine), ("dense", "dense", engine),
                             ("cpu", "fused", cpu)):
        eng.register(f"{arch}/few/{label}", sparse_model, cfg, booleanize_method=method,
                     path=path)
    for n, r in zip(sizes, requests):
        res = engine.classify(f"{arch}/few/fused", r)
        for label, eng in (("dense", engine), ("cpu", cpu)):
            other = eng.classify(f"{arch}/few/{label}", r)
            check(np.array_equal(res.predictions, other.predictions)
                  and np.array_equal(res.class_sums, other.class_sums),
                  f"few-include pool, request of {n}: fused differs from {label}")
        check(bool(res.class_sums.any()), "few-include pool: every class sum is 0")
    print(f"[engine] few-include pool ({int(few.sum())} includes): fused == dense (card) "
          f"== plain (CPU), nonzero class sums, on requests of {list(sizes)}")

    # --- 4. times at bucket 256 ----------------------------------------------
    b = 256
    spec = cfg.patch
    sm = freeze(model, cfg).to(dev)
    raw = torch.from_numpy(rng.integers(0, 256, (b, 28, 28), dtype=np.uint8)).to(dev)
    bool_imgs = threshold_booleanize(raw, 75)
    lits = ops.ingress_pack(bool_imgs, spec)
    fargs = (lits, sm.include_packed, sm.nonempty, sm.weights)
    torch.cuda.synchronize()

    errs = {
        "ingress_pack": (ops.ingress_pack(bool_imgs, spec).long()
                         - ops.ingress_pack(bool_imgs, spec, backend="plain").long()),
        "fused_infer": (ops.fused_infer(*fargs).long()
                        - ops.fused_infer(*fargs, backend="plain").long()),
    }
    max_abs = {k: int(v.abs().max()) for k, v in errs.items()}
    check(all(v == 0 for v in max_abs.values()), f"kernel/plain differ at B=256: {max_abs}")

    p, w, c, m = spec.n_patches, spec.n_words, cfg.n_clauses, cfg.n_classes
    ingress_bytes = b * spec.image_y * spec.image_x + b * p * w * 4
    ingress_ops = b * p * spec.n_literals              # one operation per literal bit
    fused_bytes = b * p * w * 4 + c * w * 4 + c + m * c + b * m * 4
    fused_ops = 2 * fused_word_tests(*fargs[:3])       # AND-NOT and test per word
    rows = []
    for name, fn, plain_fn, nbytes, nops in (
        ("ingress_pack",
         lambda: ops.ingress_pack(bool_imgs, spec),
         lambda: ops.ingress_pack(bool_imgs, spec, backend="plain"),
         ingress_bytes, ingress_ops),
        ("fused_infer",
         lambda: ops.fused_infer(*fargs),
         lambda: ops.fused_infer(*fargs, backend="plain"),
         fused_bytes, fused_ops),
    ):
        k = registry.KERNELS[name]
        ms = time_ms(fn, inner=20)
        plain_ms = time_ms(plain_fn, inner=3, repeats=5, warmup=1)
        bound_ms, bound_by = bound(nbytes, nops)
        rows.append({
            "name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[name], "max_abs_err": max_abs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
        print(f"[time] {name} B={b}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, {nops} ops)")

    imgs256, img1 = requests[3], requests[0]
    engine.classify(arch, imgs256)
    n_iter = 50
    t = time.perf_counter()
    for _ in range(n_iter):
        engine.classify(arch, imgs256)
    dt = time.perf_counter() - t
    lat = []
    for _ in range(200):
        t = time.perf_counter()
        engine.classify(arch, img1)
        lat.append(time.perf_counter() - t)
    lat.sort()
    print(f"[time] classify bucket 256: {b * n_iter / dt:.1f} cls/s "
          f"({dt / n_iter * 1e3:.4f} ms per request, {n_iter} requests)")
    print(f"[time] classify bucket 1: median {statistics.median(lat) * 1e6:.1f} us, "
          f"p90 {lat[int(0.9 * len(lat))] * 1e6:.1f} us over {len(lat)} requests")
    for label, imgs, reps in (("bucket 256", imgs256, 20), ("bucket 1", img1, 50)):
        profile_classify(engine, arch, imgs, reps, label)
    print(f"[env] {card} | build {build_s:.2f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
