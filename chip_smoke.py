#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card: build, check, serve, time.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch`` beside
this file and builds the CUDA kernels from ``src/repro_torch/csrc``).

  1. environment: the card's name and power limit (``nvidia-smi``), the
     torch and CUDA versions, the integer ceiling (SMs x 64 results per
     clock x the highest SM clock), the int8 tensor-core ceiling (SMs x
     4,096 multiply-adds per clock x the same clock, printed beside the
     data sheet's 1,979 TOPS dense), and the kernels' build time (one
     ``nvcc`` per source, all started together; with a ``git archive``
     export of the parent commit in ``_parent/``, its sources too);
  2. each CUDA kernel against its plain PyTorch version on the card,
     ``torch.equal`` after a synchronise (every output is an integer):
     the ingress kernel over six geometries (one with rows and windows
     wider than 32 columns, one whose words exceed the kernel's shared
     tile), in both modes (the adaptive one on raw pixels at five
     windows, each also at c 0, against the adaptive booleanize and the
     plain pack); the fused, clause-eval, sparse clause-eval
     and sparse fused kernels over the reference's kernel sweep with
     CSRF on and off, both density extremes, a saturating pool and the
     envelope corner, and at the autotuner's ``block_c`` 32 and 64 (CSRF
     on and off) on the paper, ragged and Table III shapes and on the
     few40 and empty pools at B=256; the sparse kernels also at C_a of 0,
     1 and 37 and on ``analyze_sparsity(pad_to=...)`` images; the class-sum kernel at
     (B, C, M) = (256, 128, 10), (3, 70, 10), (2, 1024, 64), (256, 1000,
     10), (17, 88, 10), (300, 128, 10), (1, 1, 1) and (40, 3004, 20)
     (past the envelope: the kernel refills its stages, with 4-byte
     copies), each with random bits and with one-hot fired rows against
     weights ``((m*C + c) mod 255) - 127`` (a swapped fragment shows
     there), with uint8 and bool fired; then ``[prng]``: the threefry
     kernel against known answers of ``jax.random`` (constants here, no
     JAX imported) and against its plain version (bits, float32 uniforms
     over four ranges, split pairs; 1, 3, 100 and 70,000 keys; 1 to
     46,208 counters, from 0 and across 2**32), then the main path's own
     launches recorded and held the same way (a batch-100 TM step's
     draws, 8 launches, 15.09 M outputs; every launch of h2o-danube-1.8b's
     ``init_params``; ``sample_tokens`` over float32 and bf16 logits),
     with the times of the first two beside the plain version,
     ``torch.rand`` of as many floats and the bound;
  3. the main paths: ``ServingEngine.register`` -> ``classify`` of the
     ``convcotm-mnist`` configuration (full width, seeded weights) with
     requests of 1, 3, 64, 256 and 300 images.  First the ``fused`` path
     on a boundary-initialised pool; then the ``kernel``, ``sparse``,
     ``fused_sparse`` and ``matmul_sparse`` paths on three pools
     (boundary, few includes with ~40% of clauses empty, all empty).
     Launch counters are set to 0 just before each of the two drives and
     read just after; results equal the engine's ``dense`` path on the
     card and the plain composition on the CPU.  No path calls the
     class-sum kernel: in a window of its own it sums the clause-eval
     kernel's fired bits of the same requests, which must equal the
     ``kernel`` path's class sums.  Then the adaptive and trainer paths,
     each drive in a launch window of its own: ``convcotm-fmnist`` (adaptive Gaussian
     ingress, block 11, c 2) on ``fused`` and ``fused_sparse`` with
     requests of 1, 3, 256 and 300 images, through the ingress kernel's
     adaptive mode (none of its bits mode), equal to the CPU plain
     composition and to the host ingress; the trainer at full width (6
     batch-mode steps of 100) on the card and on the CPU from one key
     (the first step's draws equal but for the Gumbel noise's logs, equal
     keys and models, or a parting only where the logs' last place
     decided); the trainer on the card (``fit``, 2 epochs of 4,000 glyphs,
     800 test, from ``prng_key(0)``, the threefry launches counted:
     samples/s per epoch, accuracy, the median samples/s over 16 further
     epochs of 40 steps on copies of the model in turns with the key
     chain and with Philox draws, a ``torch.profiler`` split of a step
     into draws, matmul, feedback and apply with the draws' share); a TM
     checkpoint written on the card after one epoch and resumed on the
     CPU, against the uninterrupted card run; the trained model frozen, registered and
     served on ``fused`` and ``fused_sparse`` and through
     ``infer_packed(use_kernel=True)``, equal to ``evaluate``'s matmul
     predictions on every test image; its 5,632-byte register image and a
     ``save_servable`` / ``restore_servable`` round trip, same predictions
     and digest.  Then the serving stack (``[service]`` lines), each drive
     in a launch window of its own: ``swap`` and ``rollback`` on the card
     (the rollback restores the displaced tensors, O(1)) and
     ``load_checkpoint`` of the trained model in both flavours; a
     ``ServingService`` under 4,096 single-image raw requests at an offered
     5,000 req/s while 8 swaps between two pools and a rollback land, every
     result equal to a direct classify of its version, one version per
     microbatch, no future hung, ingress_pack and fused_infer launched once
     per engine slice; a chaos soak (5% malformed, 5% abandoned, three
     injected engine errors) whose circuit breaker steps ``fused ->
     matmul``, with fused_infer launched before the trip and never after;
     and one lifecycle round (train, shadow, promote or reject) on the card.
     The swap storm runs under ``torch.profiler``, which splits the
     service's time per microbatch into device busy and dispatch host
     time.  Then the autotuner (``[autotune]`` lines, a launch window of
     its own): the few40 pool through ``ServingEngine(autotune=True)`` on
     ``fused``, whose warmup times every (path, params) candidate at
     buckets 1 and 256 in both forms (each kernel candidate must launch
     its tile kernel on every call); the report per (form, bucket); the
     tuned engine equal to an untuned ``fused`` engine and the CPU; the
     same plan on re-registration; ``swap(retune=True)``, ``rollback``, a
     checkpoint round trip and a plan stamped for another card; a
     lifecycle round with ``autotune_candidate``.  ``[roofline]`` lines
     hold each winner's measured cls/s against ``tm_path_roofline`` at the
     card's ceilings (achieved fraction at most 1.05).  Then the device
     mesh (``[mesh]`` lines), on meshes of cuda:0 repeated (every meshed
     code path on one card; not scaling across cards): replicated data 1,
     2 and 4, clause-sharded model 2 and 4 and 2x2, each mesh's drive a
     launch window of its own, on ``fused`` and ``kernel``, boundary and
     few40 pools, requests of 1, 13 and 256 images raw, through the host
     ingress and preprocessed, every result equal to the unmeshed engine
     on the card and to the CPU; C=1000 clause-sharded over 4 (shards of
     250); the tile kernels' clause widths (32, 64, 250 among them); a
     service over a data-4 mesh that loses two devices (4 -> 2 -> 1, hung
     0); a tuned data-2 registration; the trainer on data 2 and 4 equal to
     the unmeshed trainer; classify times per mesh ("shards on one
     card");
  4. times at bucket 256 with CUDA events (median of repeats after
     warm-up; a spin kernel holds the card while the host enqueues each
     window, so the times are the card's): the launch floor (a kernel
     that does nothing, ``torch.cuda._sleep(0)``, before and after the
     kernels), the ingress kernel in both modes (the adaptive one also
     beside the composition it replaces: the booleanize's torch
     operations, then the bits mode), each tile kernel on the boundary and
     the few-include pool, and the class sums on the few-include pool's
     fired bits (C=128, M=10) and at the envelope (C=1024, M=64, seeded
     bits, int8 weights over the full range), each beside its plain
     version, the least time the card could take, the parent commit's
     kernel when ``_parent/`` holds it (timed in turns: parent, this
     tree, this tree, parent), ``fused_infer`` and ``clause_eval`` also at
     ``block_c`` 32 and 64, and, for the class sums, one f32
     ``torch.matmul`` and one ``torch._int_mm`` (int8, classes padded to
     16 outside the window; null, with its message, where it refuses the
     shape); classify throughput at bucket 256 and
     latency at bucket 1 on ``fused`` and ``fused_sparse``, a profile of
     each;
  5. the LM substrate's serving path (``[lm]`` lines; plain PyTorch, no
     kernel of its own but threefry's draws, fp32 matmuls without TF32):
     each of the ten archs at ``reduced_config`` in fp32, drawn on the CPU
     from a key and copied to the card, runs ``prefill`` and 8 decode steps (h2o-danube
     40, so its ring of 16 wraps twice; xLSTM on the reference's 3-layer
     stack, and at its 17-layer reduced depth on weights of each layer's
     own fan-in) on both,
     logits within rtol = atol = 1e-3 and greedy tokens equal wherever
     the CPU's top-2 margin exceeds 1e-2; h2o-danube-1.8b whole in fp32,
     drawn on the card: 16 decode steps equal ``forward`` + ``lm_logits``
     (2e-3); h2o-danube-1.8b whole in bf16 through ``generate`` (batch
     4, prompt 32, 16 new tokens, greedy) twice the same tokens, at
     temperature 1 from one seed twice the same tokens, decode
     ms a step (host clock and CUDA events), tokens/s, ``prefill`` of
     1 x 2,048 tokens, peak memory, a ``torch.profiler`` split of 8
     decode steps; ``[roofline] lm`` lines put the decode byte floor
     (``hbm_bytes_estimate`` over 3.35 TB/s) and the prefill compute
     floor (``flops_estimate`` over SMs x 4,096 bf16 FLOPs per clock x
     the highest SM clock) beside them;
  6. the LM substrate's training path (``[lm train]`` lines; plain
     PyTorch, no kernel of its own, the six TM kernels' counters held at
     0, threefry's counted):
     each of the ten archs at ``reduced_config`` in fp32, microbatches
     2, remat on, drawn on the CPU from a key: one train step and
     then three on the card and on the CPU from the same weights and
     batches, held on weights of each layer's own fan-in (xLSTM at its
     17 layers: loss 1e-5, grad_norm 1e-4, the three losses 1e-4
     relative) and printed beside them on the reference's draws (xLSTM
     on the 3-layer stack); remat on against off on the card (1e-6) on
     both; h2o-danube-1.8b
     whole in fp32 at 1 x 512 tokens, on the reference's draws and on
     weights of each layer's own fan-in: ``lm_loss`` equals the served
     forward's cross entropy (1e-4), and the gradient's directional
     derivatives along g/|g| and along the embedding, layer 0's query
     weight and layer 23's MLP down projection equal central differences
     (1e-2 at a first-order change of 1e-2; held on the fan-in weights,
     printed on the reference's draws); on the reference's draws a
     float64 witness: the same model in float64, its loss and gradient,
     and central differences of the float64 loss along the same
     directions, held against the float64 and the float32 gradient
     (1e-2 at a first-order change of 1e-5); h2o-danube-1.8b whole in
     bf16 with fp32
     masters trained 8 steps at 4 x 2,048 on ``synthetic_lm_batch``
     (microbatches 2, remat full, lr 3e-4, warmup 1): each step's loss,
     grad_norm, lr and ms (host clock and CUDA events), tokens/s, peak
     memory, the losses finite and falling, a ``torch.profiler`` split
     of one more step, and ``[roofline] lm train`` (the step's compute
     floor from ``flops_estimate`` over the bf16 peak); a resumed
     ``run_training`` on the card (reduced, fp32, checkpoint at step 2)
     against the uninterrupted run (1e-5);
  7. the LM substrate over a mesh (``[lm mesh]`` lines), on meshes of the
     card repeated, the six TM kernels' counters held at 0: every reduced
     arch in fp32, 3 train steps at 4 x 32 on a (2, 2) "tp" mesh, its
     layers split over ``model`` (xLSTM on its 3-layer stack), at
     microbatches 1 against the unmeshed step at the matching count (2;
     1 for the MoE archs, whose routing groups and balance loss are the
     whole microbatch's), losses 1e-6 and grad_norm 1e-5 relative, and
     whether bit for bit, with the leaves each gathered across ``model``
     and a check that every position read its own blocks; again
     compressed for h2o-danube and qwen2-moe, in float64; phi3.5-moe at 16 experts,
     sharded over ``model``; every arch under "dp", bit for bit without MoE;
     a "serve_tp" (1, 2) decode of reduced recurrentgemma on a cache laid
     out by ``cache_shardings`` (8 steps, logits within 1e-5);
     h2o-danube-1.8b whole, bf16 with fp32 masters, 4 x 2,048,
     remat full: 3 unmeshed steps at microbatches 2, freed, then 3 on the
     (2, 2) "tp" mesh at microbatches 1 from the same initial state (each
     step's loss, grad_norm, ms on both clocks and tokens/s, the relative
     differences beside the unmeshed step's own shift when one weight
     moves one bf16 ulp, peak memory, the state's bytes a grid position
     against ``launch.dryrun.cell_bytes`` and the 25.64 GB whole, no leaf
     gathered across ``model``, every position's work, a
     ``torch.profiler`` split of one more meshed step); the same 3 steps
     in float32, step 0 (the same weights) held at 1e-3 in loss and 1e-2
     in grad_norm; its ``generate`` on a (1, 2) "serve_tp" mesh with the
     cache split by ``seq``, in bf16 (decode ms a step, the tokens
     compared, the cache bytes a position against the dry-run's) and in
     float32 (the unmeshed tokens, held); and the dry-run of
     h2o-danube-1.8b x train_4k on both production meshes (argument bytes
     a device against the card's memory, the dominant roofline term);
  8. Kimi Linear's KDA decode kernel (``[lm kda]`` lines;
     ``csrc/kda_decode.cu``) at the shape of its main path, 256 sequences
     x 32 heads x 128 x 128 float32 states: three steps of
     ``kda_decode_cuda`` against ``kda_decode_plain`` (1e-5), both timed,
     with the bound of each state read and written once (1.095 GB a
     launch); then Kimi-Linear-48B-A3B at its published widths, 64 of its
     256 experts held as the benchmark's cell holds them, through
     ``generate`` at 256 x (4 prompt ids + 4 new tokens): the wrapper's
     launches counted from zero over the first call (the capture's eager
     step and the capture, 2 a KDA layer), and a second call, the same
     tokens, profiled: one ``kda_decode`` device row a KDA layer and step
     of the replayed graph;
  9. the decode step's GQA attention kernel (``[lm gqa]`` lines;
     ``csrc/gqa_decode.cu``) at h2o-danube-1.8b's shape in the benchmark's
     cell, 256 sequences x 8 kv heads x 4 query heads each x a 256-slot
     bf16 cache x 80: at positions 15, 127 and 255 the kernel against
     ``gqa_decode_plain`` (max abs error, within the values' rounding),
     both timed beside PyTorch's one call for it
     (``F.scaled_dot_product_attention`` with ``enable_gqa`` and the bool
     mask, under each backend that takes it) and the bound of the visible
     slots' K and V read once;
     then h2o-danube-1.8b through ``generate`` at 256 x (4 prompt ids + 4
     new tokens): the wrapper's launches over the first call (the
     capture's eager step and the capture, 2 a layer), and a second call,
     the same tokens, profiled: one ``gqa_decode`` device row a layer and
     step of the replayed graph;
     then one ``{"kernels": [...]}`` line (threefry's row counts the
     fit's launches, the LM phases' beside them; kda_decode's and
     gqa_decode's rows the first call's launches and the second's
     replayed rows).

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises and exits non-zero, as does a run without CUDA or outside the
repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
#: H100 SXM published HBM3 bandwidth (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer and logic results per clock per SM on compute capability
#: 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput).
INT32_PER_CLOCK_PER_SM = 64
#: Dense int8 tensor-core multiply-adds per clock per SM on an H100 (132
#: SMs x 4,096 x 1.83 GHz boost = 1,979 TOPS at 2 operations each, the
#: data sheet's dense int8 rate).
INT8_MMA_PER_CLOCK_PER_SM = 4096
#: float32 FLOPs per clock per SM on compute capability 9.0 (128 float32
#: lanes, a fused multiply-add 2 FLOPs: the data sheet's 67 TFLOPS).
FP32_FLOPS_PER_CLOCK_PER_SM = 256
#: A git-archive export of the parent commit; when present, its kernels
#: are built and timed beside this tree's, in the same run on one card.
PARENT = Path(__file__).resolve().parent / "_parent"
#: Longest spin before a timed window, in clock cycles (~34 ms at 2 GHz).
MAX_HOLD_CYCLES = 1 << 26
#: The eval paths of the second drive, and the kernels of the first.
SLICE2_PATHS = ("kernel", "sparse", "fused_sparse", "matmul_sparse")
SLICE1_KERNELS = ("ingress_pack", "fused_infer")
#: (block_size, c) of the adaptive ingress kernel's checks: the paper's
#: window, and windows that take the 2- and 4-blocks, a 16-block chained
#: with fused multiply-adds, and 32 chained taps.
ADAPTIVE_WINDOWS = ((11, 2.0), (3, 0.5), (13, 1.5), (17, 2.0), (41, 2.0))
#: Clauses per tile that the autotuner sweeps beside the default 128.
TUNED_BLOCK_C = (32, 64)
#: The tile kernel each kernel path launches.
PATH_KERNEL = {"kernel": "clause_eval", "fused": "fused_infer",
               "sparse": "clause_eval_sparse", "fused_sparse": "fused_infer_sparse"}


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


def time_ms(fn, *, inner: int, repeats: int = 11, warmup: int = 3) -> tuple[float, bool]:
    """Median device milliseconds per call of ``fn``: ``repeats`` windows
    of ``inner`` back-to-back calls between two CUDA events.  A spin
    kernel (``torch.cuda._sleep``) holds the card before each window while
    the host enqueues it, so a window times the card's work and not the
    host's launch rate; the hold doubles until the start event is still
    pending when the host has enqueued the whole window.  Returns
    ``(ms, held)``; ``held`` is False when even the longest hold did not
    cover the host (a call that waits on the card, such as a copy from
    pageable memory), and the time then includes the host's gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles, held_all, samples = 1 << 20, True, []
    while len(samples) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        held = not start.query()
        stop.synchronize()
        if held or cycles >= MAX_HOLD_CYCLES:
            samples.append(start.elapsed_time(stop) / inner)
            held_all &= held
        else:
            cycles *= 2
    return statistics.median(samples), held_all


def max_sm_clock_mhz() -> float:
    """The highest SM clock ``nvidia-smi`` reports for card 0, in MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


def ceilings() -> tuple[float, float]:
    """The card's ceilings from its SM count and the highest SM clock
    ``nvidia-smi`` reports: integer/logic results per second (64 per clock
    per SM) and int8 tensor-core multiply-adds per second (4,096)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_clock = sms * max_sm_clock_mhz() * 1e6
    return per_clock * INT32_PER_CLOCK_PER_SM, per_clock * INT8_MMA_PER_CLOCK_PER_SM


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def start_parent_build(build_mod):
    """One ``nvcc`` per kernel source of ``PARENT``, started now, with this
    tree's flags, into ``PARENT/build``; None without a parent export."""
    csrc = PARENT / "src" / "repro_torch" / "csrc"
    if not csrc.is_dir():
        return None
    out = PARENT / "build"
    out.mkdir(exist_ok=True)
    procs = {}
    for name in build_mod.SOURCES:
        if not (csrc / f"{name}.cu").exists():      # a kernel the parent does not have
            continue
        cmd = [build_mod.nvcc_path(), *build_mod.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
               str(csrc / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    return procs


def finish_parent_build(procs) -> Path:
    """Waits for :func:`start_parent_build`'s compilers; the directory of
    the parent's libraries, for ``_build.libraries_from``."""
    for name, proc in procs.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"parent {name}.cu did not build:\n{out}")
    return PARENT / "build"


def fused_word_tests(lit, inc, ne) -> int:
    """Word tests these inputs need: for each image and nonempty clause, on
    every patch up to its first firing patch, the words up to and
    including the first violated one (all W on the patch that fires).
    The active pool's test ``~(lit | exclude)`` is this one with
    ``inc = ~exclude`` and every clause nonempty."""
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


def device_rows(rows):
    """The profiler's rows of work on the card (kernels, copies, memsets).
    An operator's row repeats its kernels' device time, so the busy time
    sums these rows only."""
    from torch.autograd import DeviceType

    return [e for e in rows if getattr(e, "device_type", None) == DeviceType.CUDA]


def self_dev_us(e) -> float:
    """A profiler row's own device time."""
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def print_top_device(label: str, on_card, n: int, unit: str) -> None:
    """The eight rows of work on the card with the most device time, per
    ``unit`` (``n`` units profiled)."""
    for e in sorted(on_card, key=self_dev_us, reverse=True)[:8]:
        if self_dev_us(e):
            print(f"[profile] {label}: device {self_dev_us(e) / n:9.2f} us/{unit} "
                  f"x{e.count // n:<3d} {e.key[:80]}")


def _profile_step(label: str, step_fn, state, batch, card: str):
    """One more step under ``torch.profiler`` (``_profile_once``).  Returns
    the state."""
    out = {}

    def run():
        out["state"], _ = step_fn(state, batch)

    _profile_once(label, run, card)
    return out["state"]


def _profile_once(label: str, run, card: str) -> None:
    """``run()`` once under ``torch.profiler``: wall and device-busy time,
    device operations, the top device rows and host rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = prof.key_averages()
    on_card = device_rows(rows)
    busy = sum(self_dev_us(e) for e in on_card)
    if busy:
        print(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy "
              f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}% of wall), idle "
              f"{100 * (1 - busy / wall_us):.1f}%; {sum(e.count for e in on_card)} device "
              f"operations a step | {card}")
        print_top_device(label, on_card, 1, "step")
        for e in sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
            print(f"[profile] {label}: host {e.self_cpu_time_total / 1e3:9.2f} ms/step "
                  f"x{e.count:<6d} {e.key[:80]}")
    else:
        print(f"[profile] {label}: the profiler captured no device time (not measured)")


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
    on_card = device_rows(rows)
    busy = sum(self_dev_us(e) for e in on_card)
    if not busy:
        print(f"[profile] {label}: the profiler captured no device time (not measured)")
        return
    copies = sum(self_dev_us(e) for e in on_card if "memcpy" in e.key.lower())
    print(f"[profile] {label}: {reps} requests, wall {wall_us / reps:.1f} us/request, "
          f"device busy {busy / reps:.1f} us/request ({100 * busy / wall_us:.1f}% of wall; "
          f"copies {copies / reps:.1f} us), idle {100 * (1 - busy / wall_us):.1f}%")
    print_top_device(label, on_card, reps, "request")
    for e in sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"[profile] {label}: host {e.self_cpu_time_total / reps:9.2f} us/request "
              f"x{e.count // reps:<3d} {e.key[:80]}")


def classify_stats(engine, name: str, imgs256, img1) -> tuple[float, float, float]:
    """On the host clock: ms per request over 50 bucket-256 requests, and
    the median and p90 µs of 200 bucket-1 requests."""
    engine.classify(name, imgs256)
    n_iter = 50
    t = time.perf_counter()
    for _ in range(n_iter):
        engine.classify(name, imgs256)
    dt = time.perf_counter() - t
    lat = []
    for _ in range(200):
        t = time.perf_counter()
        engine.classify(name, img1)
        lat.append(time.perf_counter() - t)
    lat.sort()
    return dt / n_iter * 1e3, statistics.median(lat) * 1e6, lat[int(0.9 * len(lat))] * 1e6


def classify_times(engine, name: str, imgs256, img1) -> str:
    """:func:`classify_stats` as one printable summary."""
    ms, med, p90 = classify_stats(engine, name, imgs256, img1)
    return (f"bucket 256: {256 / ms * 1e3:.1f} cls/s ({ms:.4f} ms per request, 50 "
            f"requests); bucket 1: median {med:.1f} us, p90 {p90:.1f} us over 200 requests")


def same_result(a, b) -> bool:
    import numpy as np

    return (np.array_equal(a.predictions, b.predictions)
            and np.array_equal(a.class_sums, b.class_sums))


def adaptive_serving(engine, cpu, pools, registry, dev) -> dict:
    """The adaptive path: ``convcotm-fmnist`` (adaptive Gaussian ingress,
    block 11, c 2) served on ``fused`` and ``fused_sparse`` with requests of
    1, 3, 256 and 300 glyph images and noise; the card's class sums and
    predictions must equal the CPU plain composition's.  Returns the launch
    counts of the card drive."""
    import numpy as np
    import torch

    from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
    from repro_torch.core.booleanize import adaptive_gaussian_booleanize
    from repro_torch.data import synthetic_glyphs
    from repro_torch.kernels import ops

    arch = "convcotm-fmnist"
    cfg, method = COTM_CONFIGS[arch], BOOLEANIZE_METHOD[arch]
    check(method == "adaptive", f"{arch} booleanizes with {method}")
    glyphs = synthetic_glyphs(n_train=560, n_test=0, seed=SEED + 3)[0]
    noise = np.random.default_rng(SEED + 3).integers(0, 256, (560, 28, 28), dtype=np.uint8)
    sizes = (1, 3, 256, 300)
    requests, at = [], 0
    for n in sizes:
        requests.append(np.concatenate([glyphs[at : at + n - n // 2], noise[at : at + n // 2]]))
        at += n
    names = {"fused": pools["few"], "fused_sparse": pools["few40"]}
    for path, model in names.items():
        for eng in (engine, cpu):
            eng.register(f"{arch}/{path}", model, cfg, booleanize_method=method, path=path)
        check(engine.ingress_spec(f"{arch}/{path}").resolved_method == "adaptive"
              and engine.ingress_spec(f"{arch}/{path}").block_size == 11
              and engine.ingress_spec(f"{arch}/{path}").c == 2.0,
              f"{arch}/{path}: ingress {engine.ingress_spec(f'{arch}/{path}')}")
        engine.warmup(f"{arch}/{path}")
    registry.reset_launches()
    served = {(path, i): engine.classify(f"{arch}/{path}", r)
              for path in names for i, r in enumerate(requests)}
    launches = registry.launch_counts()
    print(f"[engine] launches during classify of {arch} (adaptive ingress) on "
          f"{list(names)}: {launches}")
    for name in ("ingress_pack_adaptive", "fused_infer", "fused_infer_sparse"):
        check(launches[name] > 0, f"kernel {name} was not launched on the adaptive paths")
    check(launches["ingress_pack"] == 0,
          f"the adaptive paths launched the bits mode: {launches['ingress_pack']}")
    for path in names:
        for i, (n, r) in enumerate(zip(sizes, requests)):
            res = served[path, i]
            check(res.class_sums.shape == (n, cfg.n_classes), f"{path}: bad result shape")
            check(same_result(res, cpu.classify(f"{arch}/{path}", r)),
                  f"{arch} request of {n}: {path} on the card differs from the CPU plain "
                  f"composition")
            check(same_result(res, cpu.classify(f"{arch}/{path}", r, ingress="host")),
                  f"{arch} request of {n}: {path} differs from the host ingress")
        check(bool(served[path, 2].class_sums.any()), f"{arch}/{path}: every class sum is 0")
    # The adaptive bits themselves, card against CPU, and the kernel's words
    # against its twin's, on every request.
    for r in requests:
        x = torch.from_numpy(r)
        check(torch.equal(adaptive_gaussian_booleanize(x.to(dev)).cpu(),
                          adaptive_gaussian_booleanize(x)),
              "adaptive booleanize on the card differs from the CPU")
        check(torch.equal(ops.ingress_pack_adaptive(x.to(dev), cfg.patch),
                          ops.ingress_pack_adaptive(x.to(dev), cfg.patch, backend="plain")),
              f"ingress_pack_adaptive differs from its twin on a request of {len(r)}")
    ones = float(adaptive_gaussian_booleanize(torch.from_numpy(requests[2])).float().mean())
    print(f"[engine] {arch}: fused, fused_sparse == plain (CPU) == host ingress (CPU) on "
          f"requests of {list(sizes)} (glyphs and noise); adaptive bits card == CPU "
          f"({ones:.3f} of the bits set); ingress_pack_adaptive == its twin on each")
    return launches


def _gumbel_apart(a, b, u) -> float:
    """Largest distance of two Gumbel draws ``-log(-log(u))`` of the same
    uniforms ``u`` whose logs round apart, in units of one ulp at each log:
    ``spacing(t) / t + spacing(g)`` (``t = -log(u)``; the inner log's ulp
    moves the result by the first term, the outer's by the second)."""
    import torch

    def spacing(x):
        x = x.float()
        return x.nextafter(torch.tensor(float("inf"))).double() - x.double()

    a, b, u = a.double().cpu(), b.double().cpu(), u.double().cpu()
    t = -torch.log(u)
    unit = spacing(t) / t + spacing(b.abs())
    return float(((a - b).abs() / unit).max()) if a.numel() else 0.0


def _patch_uniforms(k, b: int, cfg):
    """The uniforms behind a step's Gumbel noise, from its step key ``k``
    (as ``make_draws`` splits it), on the key's device."""
    import numpy as np

    from repro_torch.core import prng

    k_patch = prng.split(prng.split(k, b), 7)[:, 0]
    return prng.uniform(k_patch, (cfg.patch.n_patches, cfg.n_clauses),
                        minval=float(np.finfo(np.float32).tiny))


def _first_parting(cfg, lits, labels, idx, m0, key_a, key_b, dev_a, dev_b):
    """Replay batch-mode steps from one model and two copies of a key on two
    devices (the engine's ``key, k = split(key)`` chain over the index rows
    ``idx``).  Returns None when every step's models agree, else (step,
    the number of patch choices of fired clauses that differ, the largest
    distance of the two devices' Gumbel noise at those choices in units of
    one ulp at each log, see :func:`_gumbel_apart`)."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core import train as tt

    ma = type(m0)(ta_state=m0.ta_state.to(dev_a), weights=m0.weights.to(dev_a))
    mb = type(m0)(ta_state=m0.ta_state.to(dev_b), weights=m0.weights.to(dev_b))
    for step, ix in enumerate(idx):
        key_a, ka = prng.split(key_a).unbind(0)
        key_b, kb = prng.split(key_b).unbind(0)
        da, db = tt.make_draws(ka, len(ix), cfg), tt.make_draws(kb, len(ix), cfg)
        la, ya = lits[ix].to(dev_a), labels[ix].to(dev_a)
        na = tt.update_batch_literals(da, ma, la, ya, cfg)
        nb = tt.update_batch_literals(db, mb, lits[ix].to(dev_b), labels[ix].to(dev_b), cfg)
        if torch.equal(na.ta_state.cpu(), nb.ta_state.cpu()) and torch.equal(
                na.weights.cpu(), nb.weights.cpu()):
            ma, mb = na, nb
            continue
        cp = tt._train_patch_outputs(la, ma.include, cfg) > 0
        fired = cp.any(dim=1)
        ga, gb = da.gumbel, db.gumbel.to(dev_a)
        pa = torch.where(cp, ga, float("-inf")).argmax(dim=1)
        pb = torch.where(cp, gb, float("-inf")).argmax(dim=1)
        parted = ((pa != pb) & fired).nonzero().tolist()
        u = _patch_uniforms(kb, len(ix), cfg)
        apart = [0.0]
        for b, c in parted:
            at = [int(pa[b, c]), int(pb[b, c])]
            apart.append(_gumbel_apart(ga[b, at, c], gb[b, at, c], u[b, at, c]))
        return step, len(parted), max(apart)
    return None


def trainer_card_equals_cpu(dev) -> None:
    """The trainer at full width (convcotm-mnist, P=361, 2o=272, C=128) takes
    6 batch-mode steps of 100 on the card and on the CPU from one key
    (``prng_key``, the reference's ``PRNGKey``): the card draws through the
    threefry kernel, the CPU through its plain version.  The first step's
    uniforms and negative classes are equal bit for bit, its Gumbel noise
    within 2 ulp at each log (CUDA's ``log`` against the CPU's); the
    advanced keys are equal; the models are equal, or at the first step
    where they part every differing patch choice lies where the two
    devices' noise is within that bound (the logs' last place decided)."""
    import torch

    from repro_torch.configs.convcotm import COTM_CONFIGS
    from repro_torch.core import prng
    from repro_torch.core.prng import prng_key
    from repro_torch.core.train import make_draws
    from repro_torch.data import PipelineState, epoch_permutation, synthetic_glyphs
    from repro_torch.kernels import registry
    from repro_torch.train.tm_engine import TrainerEngine

    cfg = COTM_CONFIGS["convcotm-mnist"]
    b, steps = 100, 6
    tx, ty, _, _ = synthetic_glyphs(n_train=b * steps, n_test=0, seed=SEED + 5)
    card = TrainerEngine(cfg, batch_size=b)
    host = TrainerEngine(cfg, batch_size=b, device="cpu")
    check(card.device.type == "cuda", f"trainer runs on {card.device}")
    ds_card, ds_cpu = card.prepare(tx, ty), host.prepare(tx, ty)
    check(torch.equal(ds_card.literals.cpu(), ds_cpu.literals),
          "prepared literals differ between the card and the CPU")
    k_card, k_cpu = prng_key(SEED + 7, dev), prng_key(SEED + 7)
    first = prng.split(k_cpu).unbind(0)[1]
    d_card, d_cpu = make_draws(first.to(dev), b, cfg), make_draws(first, b, cfg)
    torch.cuda.synchronize()
    for name in ("neg", "u_t", "u_q", "u_ia1", "u_ia0", "u_ib"):
        check(torch.equal(getattr(d_card, name).cpu(), getattr(d_cpu, name)),
              f"trainer draws: {name} differs between the card and the CPU from one key")
    g_ulps = _gumbel_apart(d_card.gumbel, d_cpu.gumbel, _patch_uniforms(first, b, cfg))
    g_apart = int((d_card.gumbel.cpu() != d_cpu.gumbel).sum())
    if g_ulps > 2:
        # Which side moved: each draws its noise again from the same key.
        i = int((d_card.gumbel.cpu().double() - d_cpu.gumbel.double()).abs().argmax())
        again_cpu = make_draws(first, b, cfg).gumbel
        again_card = make_draws(first.to(dev), b, cfg).gumbel.cpu()
        check(False, f"trainer draws: Gumbel noise {g_ulps} ulp apart at its logs; the "
              f"largest difference at flat index {i}: card {float(d_card.gumbel.flatten()[i])!r}, "
              f"CPU {float(d_cpu.gumbel.flatten()[i])!r}; drawn again, the CPU "
              f"{'repeats' if torch.equal(again_cpu, d_cpu.gumbel) else 'differs'}, the card "
              f"{'repeats' if torch.equal(again_card, d_card.gumbel.cpu()) else 'differs'}")
    m0 = host.init_model(prng_key(SEED))
    t = time.perf_counter()
    kc, m_cpu, _, n_cpu = host.run_epoch(k_cpu, m0, ds_cpu, PipelineState(seed=SEED))
    cpu_s = time.perf_counter() - t
    registry.reset_launches()
    kd, m_card, _, n_card = card.run_epoch(k_card, card.init_model(prng_key(SEED)), ds_card,
                                           PipelineState(seed=SEED))
    torch.cuda.synchronize()
    launches = registry.launch_counts()["threefry"]
    check(launches > 0, "trainer: the card drew without the threefry kernel")
    check(n_cpu == n_card == b * steps, f"trained {n_cpu} and {n_card} samples")
    check(torch.equal(kd.cpu(), kc), "trainer: the advanced keys differ")
    equal = torch.equal(m_card.ta_state.cpu(), m_cpu.ta_state) and torch.equal(
        m_card.weights.cpu(), m_cpu.weights)
    moved = int((m_cpu.ta_state != m0.ta_state).sum())
    check(moved > 0 and bool((m_cpu.weights != m0.weights).any()),
          "trainer: the steps changed no TA state or no weight")
    verdict = "ta_state and weights equal"
    if not equal:
        idx = torch.from_numpy(epoch_permutation(SEED, 0, b * steps).reshape(steps, b)
                               .astype("int64"))
        part = _first_parting(cfg, ds_cpu.literals, ds_cpu.labels, idx, m0, k_card, k_cpu,
                              dev, torch.device("cpu"))
        check(part is not None and part[1] > 0 and part[2] <= 2,
              f"trainer: the card's model parts from the CPU's: {part}")
        verdict = (f"models part at step {part[0]}: {part[1]} patch choices flip where the "
                   f"noise is {part[2]:.2f} ulp apart at its logs")
    print(f"[train] card == CPU from one key: {steps} batch-mode steps of {b} at full width "
          f"(P=361, 2o=272, C=128): first step's uniforms and negative classes equal, Gumbel "
          f"noise {g_apart} of {d_cpu.gumbel.numel()} values apart by at most {g_ulps:.2f} "
          f"ulp at its logs; keys equal; {verdict} ({moved} TA states and "
          f"{int((m_cpu.weights != m0.weights).sum())} weights moved; {launches} threefry "
          f"launches on the card, {launches // steps} a step; CPU {cpu_s:.2f} s)")


def profile_train_steps(trainer, model, ds, key, steps: int, card: str) -> None:
    """Where a training step's time goes on the card: ``torch.profiler`` over
    ``steps`` batch-mode steps, each drawing from the key chain as ``fit``
    does, with the host time of each part of the step (the trainer's
    spans: draws, matmul, feedback, apply; host ranges, with no device
    range on the card), the draws' share of the step and the threefry
    kernel's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import prng
    from repro_torch.core.train import _step_literals, make_draws
    from repro_torch.spans import span

    b, cfg = trainer.batch_size, trainer.config
    ix = torch.arange(b, device=ds.literals.device)
    lits, labels = ds.literals[ix], ds.labels[ix]
    chain = [key]

    def step(m):
        with span("train.draws"):
            chain[0], k = prng.split(chain[0]).unbind(0)
            d = make_draws(k, b, cfg)
        return _step_literals(d, m, lits, labels, cfg, "batch")

    model = step(model)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            model = step(model)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = prof.key_averages()
    kernels = device_rows(rows)
    busy = sum(self_dev_us(e) for e in kernels)
    threefry_us = sum(self_dev_us(e) for e in kernels if "threefry" in e.key)
    parts = {}
    for e in rows:
        if e.key.startswith("train."):
            parts[e.key] = parts.get(e.key, 0.0) + e.cpu_time_total
    print(f"[profile] train step (batch 100, full width): {steps} steps, wall "
          f"{wall_us / steps:.1f} us/step, device busy {busy / steps:.1f} us/step "
          f"({100 * busy / wall_us:.1f}% of wall), idle {100 * (1 - busy / wall_us):.1f}% | "
          f"{card}")
    for name in ("train.draws", "train.matmul", "train.feedback", "train.apply"):
        print(f"[profile] train step {name[6:]}: host {parts.get(name, 0.0) / steps:.1f} "
              f"us/step")
    host_draws = parts.get("train.draws", 0.0)
    print(f"[profile] train step draws' share: host {100 * host_draws / wall_us:.1f}% of the "
          f"wall; threefry kernel {threefry_us / steps:.1f} us/step of device time "
          f"({100 * threefry_us / max(busy, 1e-9):.1f}% of busy) | {card}")
    print_top_device("train step", kernels, steps, "step")


def philox_draws(trainer, seed: int):
    """The trainer's draws as the port made them before it drew from keys:
    ``torch.rand``/``torch.randint`` of a card generator (Philox), one
    TrainDraws per step, without end.  A yardstick for the key stream's
    cost, not a source the package offers."""
    import torch

    from repro_torch.core.train import TrainDraws

    cfg, b, dev = trainer.config, trainer.batch_size, trainer.device
    p, c, n, m = cfg.patch.n_patches, cfg.n_clauses, cfg.n_literals, cfg.n_classes
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    while True:
        u = rand(b, p, c).clamp_(min=torch.finfo(torch.float32).tiny)
        yield TrainDraws(gumbel=-torch.log(-torch.log(u)),
                         neg=torch.randint(0, m - 1, (b,), generator=g, device=dev),
                         u_t=rand(b, c), u_q=rand(b, c), u_ia1=rand(b, c, n),
                         u_ia0=rand(b, c, n), u_ib=rand(b, c, n))


def per_key_draws(trainer, key):
    """The key chain's draws as ``make_draws`` made them before it drew the
    keys of one shape together: each of a sample's seven keys in calls of
    its own (11 launches a step, the chain's split included).  The same
    numbers as the key chain; a yardstick, not a source the package offers."""
    from repro_torch.core import prng
    from repro_torch.core.train import TrainDraws

    cfg, b = trainer.config, trainer.batch_size
    p, c, n, m = cfg.patch.n_patches, cfg.n_clauses, cfg.n_literals, cfg.n_classes
    key = key.to(trainer.device)
    while True:
        key, k = prng.split(key).unbind(0)
        k_patch, k_neg, k_t, k_q, k_ia1, k_ia0, k_ib = prng.split(prng.split(k, b),
                                                                  7).unbind(1)
        yield TrainDraws(gumbel=prng.gumbel(k_patch, (p, c)),
                         neg=prng.randint(k_neg, (), 0, m - 1),
                         u_t=prng.uniform(k_t, (c,)), u_q=prng.uniform(k_q, (c,)),
                         u_ia1=prng.uniform(k_ia1, (c, n)), u_ia0=prng.uniform(k_ia0, (c, n)),
                         u_ib=prng.uniform(k_ib, (c, n)))


def train_rate(trainer, model, ds, key, epochs: int, card: str) -> None:
    """The trainer's rate over a window longer than one epoch: ``epochs``
    further batch-mode epochs on a copy of ``model`` (no evaluation), each
    timed by ``fit`` from its first launch to the card's last step, in
    turns of ``epochs // 2`` with the key chain (the threefry kernel, 8
    launches a step), with the same draws a key at a time
    (:func:`per_key_draws`, 11 launches) and with Philox draws
    (:func:`philox_draws`, the port's draws before); first holds one step
    of the per-key draws equal to the key chain's; prints the median, the
    least and the most samples/s of each and the steps covered."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.cotm import CoTMModel
    from repro_torch.core.train import make_draws

    one = next(per_key_draws(trainer, key))
    want = make_draws(prng.split(key.to(trainer.device)).unbind(0)[1], trainer.batch_size,
                      trainer.config)
    check(all(torch.equal(getattr(one, f), getattr(want, f)) for f in
              ("gumbel", "neg", "u_t", "u_q", "u_ia1", "u_ia0", "u_ib")),
          "[train] the per-key draws differ from make_draws'")
    turns = ("key", "per_key", "philox", "philox", "per_key", "key")
    rates = {t: [] for t in turns}
    steps = 0
    for turn in turns:
        copy = CoTMModel(ta_state=model.ta_state.clone(), weights=model.weights.clone())
        source = {"key": lambda: key, "per_key": lambda: per_key_draws(trainer, key),
                  "philox": lambda: philox_draws(trainer, SEED + 31)}[turn]()
        *_, reports = trainer.fit(source, copy, ds, epochs=epochs // 2)
        rates[turn] += [r.samples_per_s for r in reports]
        steps = sum(r.samples for r in reports) // trainer.batch_size // len(reports)
    for turn, label in (("key", "key chain (threefry kernel, 8 launches a step)"),
                        ("per_key", "key chain a key at a time (11 launches a step, the "
                                    "form before)"),
                        ("philox", "Philox draws (torch.rand, the port's before)")):
        r = sorted(rates[turn])
        print(f"[train] rate, {label}: median {statistics.median(r):.1f} samples/s over "
              f"{len(r)} epochs of {steps} steps (batch {trainer.batch_size}, full width, "
              f"batch mode; least {r[0]:.1f}, most {r[-1]:.1f}; in turns "
              f"{', '.join(turns)}) | {card}")


#: Known answers of ``jax.random`` (JAX 0.9.0 on the CPU, threefry2x32,
#: partitionable), written here so the card's draws are held against the
#: reference without importing it.  Floats as ``float.hex``.
PRNG_KNOWN = {
    "split(PRNGKey(0))": [[1797259609, 2579123966], [928981903, 3453687069]],
    "bits(PRNGKey(0), (6,))": [4070199207, 4202968722, 1427181096, 2012915765, 2447653815,
                               710830403],
    "uniform(PRNGKey(0), (4,))": ["0x1.e5349c0000000p-1", "0x1.f5086c0000000p-1",
                                  "0x1.5444380000000p-2", "0x1.dfeaa00000000p-2"],
    "bits(key 0x12345678 0x9ABCDEF0, (5,))": [1301508282, 621857182, 3376475320,
                                              2348759505, 459113140],
    "split(key 0x12345678 0x9ABCDEF0, 3)": [[3978822521, 2696639427],
                                            [2085429205, 1499321931],
                                            [1630462717, 2825784901]],
    "randint(PRNGKey(42), (6,), 0, 9)": [0, 6, 0, 1, 2, 6],
    "uniform(PRNGKey(42), (3,), -3.7, 2.1)": ["-0x1.bb20c80000000p-1",
                                              "0x1.f14d8c0000000p-3",
                                              "-0x1.0147d00000000p-3"],
}
#: Integer operations of one threefry2x32-20 hash (csrc/threefry.cu): two
#: key adds, 20 rounds of add / rotate / xor, five injections of three adds,
#: and the output's xor.
THREEFRY_OPS = 78


def _recorded_threefry(fn):
    """``fn()`` with every ``ops.threefry`` call it makes recorded: returns
    (its result, the calls as ``(keys, n, mode, keywords)``), so that the
    main path's own launches can be replayed, timed and held against the
    plain version at their real shapes and counters."""
    from repro_torch.kernels import ops

    calls, launch = [], ops.threefry

    def record(keys, n, mode="bits", **kw):
        calls.append((keys.clone(), n, mode, kw))
        return launch(keys, n, mode, **kw)

    ops.threefry = record
    try:
        return fn(), calls
    finally:
        ops.threefry = launch


def _replay(calls, backend=None) -> list:
    from repro_torch.kernels import ops

    return [ops.threefry(k, n, m, backend=backend, **kw) for k, n, m, kw in calls]


def _hold_calls(calls, what: str) -> float:
    """Each recorded call's kernel output against the plain version's on the
    card, one call at a time (``torch.equal``); the largest difference."""
    import torch

    err = 0.0
    for call in calls:
        (a,), (w,) = _replay([call]), _replay([call], "plain")
        torch.cuda.synchronize()
        check(a.dtype == w.dtype and torch.equal(a, w),
              f"[prng] {what}: threefry differs from plain at K={call[0].shape[0]} "
              f"N={call[1]} {call[2]} {call[3]}")
        err = max(err, float((a.double() - w.double()).abs().max()))
        del a, w
    return err


def _call_bytes(calls) -> int:
    """Bytes a call must move: its keys read, its output written."""
    return sum(k.numel() * 4 + k.shape[0] * n * (8 if m == "pairs" else 4)
               for k, n, m, _ in calls)


def prng_phase(dev, card: str, ops_per_s: float) -> dict:
    """[prng]: the threefry kernel against ``jax.random``'s known answers and
    against its plain version on the card (``torch.equal``: bits, float32
    uniforms at four ranges, split pairs; K = 1, 3, 100 and 70,000 keys, the
    last past grid.y's 65,535; N = 1, 7, 1,001 and a TM step's 46,208;
    counters from 0 and across the 2**32 boundary); then the main path's
    own launches, recorded and each held against the plain version the same
    way: one batch-100 TM step's draws (8 launches, 15.09 M outputs), every
    launch of h2o-danube-1.8b's ``init_params`` (N up to 81.9 M, stacked
    layers' slices at their counters) and of ``sample_tokens`` over float32
    and bf16 logits; and the times of the first two beside the plain
    version, ``torch.rand`` of as many floats and the bound.  Returns the
    kernel's row for the ``kernels`` line."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.convcotm import COTM_CONFIGS
    from repro_torch.core import prng
    from repro_torch.kernels import ops, registry
    from repro_torch.launch.specs import model_decls
    from repro_torch.core.train import make_draws
    from repro_torch.models.base import init_params
    from repro_torch.train.serve_step import sample_tokens

    def floats(xs):
        return [float.fromhex(x) for x in xs]

    hi = prng.key_from_data([0x12345678, 0x9ABCDEF0], dev)
    got = {
        "split(PRNGKey(0))": prng.key_data(prng.split(prng.prng_key(0, dev))).tolist(),
        "bits(PRNGKey(0), (6,))": prng.random_bits(prng.prng_key(0, dev), 6).cpu().numpy()
        .view(np.uint32).tolist(),
        "uniform(PRNGKey(0), (4,))": prng.uniform(prng.prng_key(0, dev), 4).tolist(),
        "bits(key 0x12345678 0x9ABCDEF0, (5,))": prng.random_bits(hi, 5).cpu().numpy()
        .view(np.uint32).tolist(),
        "split(key 0x12345678 0x9ABCDEF0, 3)": prng.key_data(prng.split(hi, 3)).tolist(),
        "randint(PRNGKey(42), (6,), 0, 9)": prng.randint(prng.prng_key(42, dev), 6, 0, 9)
        .tolist(),
        "uniform(PRNGKey(42), (3,), -3.7, 2.1)": prng.uniform(prng.prng_key(42, dev), 3,
                                                              minval=-3.7, maxval=2.1).tolist(),
    }
    for name, want in PRNG_KNOWN.items():
        want = floats(want) if isinstance(want[0], str) else want
        check(got[name] == want, f"[prng] {name} on the card: {got[name]} != jax's {want}")
    print(f"[prng] known answers of jax.random on the card: {', '.join(PRNG_KNOWN)}")

    base = prng.split(prng.prng_key(SEED + 41, dev), 70000)
    tiny = float(np.finfo(np.float32).tiny)
    ranges = ((0.0, 1.0), (tiny, 1.0), (float(np.nextafter(np.float32(-1), np.float32(0))),
                                        1.0), (-3.7, 2.1))
    cases = 0
    for k in (1, 3, 100, 70000):
        keys = base[:k].contiguous()
        for n in ((1, 7, 1001, 46208) if k <= 100 else (1, 7)):
            for start in (0, 2**32 - 5):
                for mode, lo_hi in (("bits", ranges[:1]), ("pairs", ranges[:1]),
                                    ("uniform", ranges)):
                    for lo, hi_ in lo_hi:
                        a = ops.threefry(keys, n, mode, start=start, minval=lo, maxval=hi_)
                        want = ops.threefry(keys, n, mode, start=start, minval=lo, maxval=hi_,
                                            backend="plain")
                        torch.cuda.synchronize()
                        check(a.dtype == want.dtype and torch.equal(a, want),
                              f"[prng] threefry differs from plain: K={k} N={n} "
                              f"start={start} {mode} [{lo}, {hi_})")
                        cases += 1
    print(f"[kernel] threefry == plain: {cases} cases (bits, pairs, uniform over 4 ranges; "
          f"K = 1, 3, 100, 70000; N = 1, 7, 1001, 46208; counters from 0 and 2**32 - 5)")

    # One TM step's draws, launch for launch: the engine's chain split and
    # make_draws, recorded and replayed.
    cfg = COTM_CONFIGS["convcotm-mnist"]
    b = 100
    step_key = prng.prng_key(SEED + 43, dev)
    _, calls = _recorded_threefry(
        lambda: make_draws(prng.split(step_key).unbind(0)[1], b, cfg))
    outputs = hashes = sum(k.shape[0] * n for k, n, _, _ in calls)
    nbytes = _call_bytes(calls)
    err = _hold_calls(calls, "a TM step's draws")
    before = registry.launch_counts()["threefry"]
    _replay(calls)
    per_step = registry.launch_counts()["threefry"] - before
    check(per_step == len(calls), f"[prng] a TM step replayed {per_step} launches of "
          f"{len(calls)} calls")
    ms, held = time_ms(lambda: _replay(calls), inner=10)
    plain_ms, _ = time_ms(lambda: _replay(calls, "plain"), inner=2, repeats=5, warmup=1)
    library_ms, _ = time_ms(lambda: torch.rand(outputs, device=dev), inner=10)
    bound_ms, bound_by = bound(nbytes, hashes * THREEFRY_OPS, ops_per_s)
    print(f"[time] threefry, one TM step's draws (batch 100, full width: {per_step} launches, "
          f"{outputs:,} outputs): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, torch.rand of "
          f"{outputs:,} floats {library_ms:.5f} ms, bound {bound_ms:.4g} ms ({bound_by}: "
          f"{nbytes:,} B, {hashes * THREEFRY_OPS:,} ops){'' if held else '; host gaps'} | "
          f"{card}")

    # h2o-danube-1.8b's init_params on the card: its launches recorded (each
    # leaf's normal draws its uniforms; a stacked layer its slice of the
    # stack's counters), then each held against the plain version and timed.
    h2o = get_config("h2o-danube-1.8b")
    torch.cuda.synchronize()
    t = time.perf_counter()
    model, init_calls = _recorded_threefry(
        lambda: init_params(model_decls(h2o), prng.prng_key(SEED, dev)))
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t
    del model
    torch.cuda.empty_cache()
    init_err = _hold_calls(init_calls, "h2o-danube-1.8b's init_params")
    widest = max(init_calls, key=lambda c: c[1])
    furthest = max(init_calls, key=lambda c: c[3].get("start", 0))
    init_ms, _ = time_ms(lambda: _replay(init_calls), inner=1, repeats=3, warmup=1)
    init_out = sum(k.shape[0] * n for k, n, _, _ in init_calls)
    init_bound, init_by = bound(_call_bytes(init_calls), init_out * THREEFRY_OPS, ops_per_s)
    print(f"[kernel] threefry == plain over h2o-danube-1.8b's init_params: {len(init_calls)} "
          f"launches, {init_out:,} outputs; the widest N = {widest[1]:,}, the furthest start "
          f"{furthest[3].get('start', 0):,} (N = {furthest[1]:,})")
    print(f"[time] threefry, h2o-danube-1.8b init_params' uniforms ({len(init_calls)} "
          f"launches, {init_out:,} outputs): kernel {init_ms:.4f} ms, bound {init_bound:.4g} "
          f"ms ({init_by}); the whole init_params on the card (erf_inv in torch operations, "
          f"bf16 cast) {whole_s:.3f} s host clock | {card}")

    # Sampling: categorical over a served batch's logits, float32 and bf16.
    vocab = h2o.vocab_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    logits = torch.randn(4, vocab, device=dev, generator=gen)
    sample_key = prng.prng_key(SEED + 47, dev)
    for dtype in (torch.float32, torch.bfloat16):
        _, sample_calls = _recorded_threefry(
            lambda: sample_tokens(sample_key, logits.to(dtype), temperature=0.8))
        err = max(err, _hold_calls(sample_calls, f"sampling over {dtype} logits"))
        print(f"[kernel] threefry == plain in sample_tokens over [4, {vocab}] {dtype} logits: "
              f"{[(c[2], c[0].shape[0], c[1], c[3]) for c in sample_calls]}")
    k = registry.KERNELS["threefry"]
    return {"name": "threefry", "route": "cuda", "source": k.source, "replaces": k.replaces,
            "pool": None, "launches": None, "max_abs_err": max(err, init_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "launches_per_tm_step": per_step,
            "h2o_init_ms": init_ms, "h2o_init_bound_ms": init_bound,
            "h2o_init_s_whole": whole_s}


def trainer_on_card(engine, registry, dev, card: str) -> dict:
    """The trainer on the card and the train -> serve hand-off: fit 2
    epochs on 4,000 glyphs (800 test) from ``prng_key(0)`` (its draws from
    the threefry kernel, its launches counted over the fit), then
    freeze_servable -> register -> classify the test split on ``fused``
    (and ``fused_sparse``, and ``infer_packed(use_kernel=True)``); the
    predictions must equal evaluate's matmul path on every image.  Then the
    register image and a servable checkpoint round trip.  Returns the
    launch counts of the serving drive and the fit, and the trained model
    (with its servable, test split and predictions)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpointer import restore_servable, save_servable
    from repro_torch.configs.convcotm import COTM_CONFIGS
    from repro_torch.core.cotm import infer_packed
    from repro_torch.core.ingress import IngressSpec, apply_ingress
    from repro_torch.core.model_io import model_size_bytes, pack_model, unpack_model
    from repro_torch.core.prng import prng_key
    from repro_torch.data import synthetic_glyphs
    from repro_torch.serve.servable import servable_digest
    from repro_torch.train.tm_engine import TrainerEngine

    arch = "convcotm-mnist"
    cfg = COTM_CONFIGS[arch]
    tx, ty, vx, vy = synthetic_glyphs(n_train=4000, n_test=800, seed=SEED)
    trainer = TrainerEngine(cfg, batch_size=100)
    t = time.perf_counter()
    train_ds, eval_ds = trainer.prepare(tx, ty), trainer.prepare(vx, vy)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t
    key = prng_key(SEED, trainer.device)
    model = trainer.init_model(key)
    registry.reset_launches()
    key, model, state, reports = trainer.fit(key, model, train_ds, epochs=2, eval_ds=eval_ds)
    fit_launches = registry.launch_counts()
    print(f"[engine] launches during fit (2 epochs of 40 steps, evaluation included): "
          f"{fit_launches}")
    check(fit_launches["threefry"] >= 80, "fit did not draw through the threefry kernel")
    for r in reports:
        print(f"[train] convcotm-mnist on glyphs (4,000 train / 800 test), batch 100, batch "
              f"mode: epoch {r.epoch}: {r.samples_per_s:.1f} samples/s ({r.samples} samples "
              f"in {r.seconds:.4f} s), evaluate accuracy {r.accuracy:.4f} | {card}")
    acc = trainer.evaluate(model, eval_ds)
    check(acc == reports[-1].accuracy, "evaluate is not deterministic")
    print(f"[train] prepare (ingress of 4,800 images to literals on the card) {prep_s:.3f} s")
    train_rate(trainer, model, train_ds, key, 16, card)
    profile_train_steps(trainer, model, train_ds, key, 20, card)

    servable = trainer.freeze_servable(model, state)
    check(servable.version.epoch == 2 and servable.version.digest == servable_digest(servable),
          f"frozen servable stamp {servable.version}")
    want = trainer.predict(model, eval_ds).cpu().numpy()
    for path in ("fused", "fused_sparse"):
        engine.register(f"{arch}/trained/{path}", servable, path=path)
        engine.warmup(f"{arch}/trained/{path}")
    spec = IngressSpec(cfg.patch)
    words = apply_ingress(spec, torch.from_numpy(vx[:256]).to(dev))
    torch.cuda.synchronize()
    registry.reset_launches()
    res = {path: engine.classify(f"{arch}/trained/{path}", vx) for path in ("fused",
                                                                           "fused_sparse")}
    pk_pred, pk_sums = infer_packed(model, words, cfg, use_kernel=True)
    pk_pred = pk_pred.cpu().numpy()
    launches = registry.launch_counts()
    print(f"[engine] launches while serving the trained model (fused, fused_sparse; "
          f"infer_packed(use_kernel=True)): {launches}")
    for name in ("ingress_pack", "fused_infer", "fused_infer_sparse", "clause_eval"):
        check(launches[name] > 0, f"kernel {name} was not launched serving the trained model")
    for path, r in res.items():
        check(np.array_equal(r.predictions, want),
              f"trained model: {path} predictions differ from evaluate's on "
              f"{int((r.predictions != want).sum())} of {len(want)} images")
        served_acc = float((r.predictions == vy).sum()) / len(vy)
        check(served_acc == acc, f"{path} accuracy {served_acc} != evaluate's {acc}")
    check(np.array_equal(res["fused"].class_sums, res["fused_sparse"].class_sums),
          "trained model: fused and fused_sparse class sums differ")
    check(np.array_equal(pk_pred, want[:256]),
          "infer_packed(use_kernel=True) differs from evaluate's predictions")
    n_active = engine.servable(f"{arch}/trained/fused_sparse").sparsity.n_active
    print(f"[engine] trained model (C_a={n_active} of {cfg.n_clauses} active): fused == "
          f"fused_sparse == evaluate (matmul) on all {len(want)} test images, accuracy "
          f"{acc:.4f}; infer_packed(use_kernel=True) == evaluate on 256")

    blob = pack_model(model, cfg)
    check(len(blob) == model_size_bytes(cfg) == 5632, f"register image of {len(blob)} bytes")
    unpacked = unpack_model(blob, cfg)                  # the card by default
    check(unpacked.ta_state.device == dev, f"unpack_model placed the model on "
          f"{unpacked.ta_state.device}, not on {dev}")
    engine.register(f"{arch}/unpacked", unpacked, cfg, path="fused")
    check(np.array_equal(engine.classify(f"{arch}/unpacked", vx).predictions, want),
          "the unpacked register image classifies differently")
    with tempfile.TemporaryDirectory() as d:
        save_servable(servable, d, state.epoch)
        restored, step = restore_servable(cfg, d)           # the card by default
    check(restored.include_packed.device == dev, f"restore_servable placed the servable "
          f"on {restored.include_packed.device}, not on {dev}")
    check(step == state.epoch and restored.version == servable.version
          and servable_digest(restored) == servable.version.digest,
          f"restored servable stamp {restored.version} != {servable.version}")
    engine.register(f"{arch}/restored", restored, path="fused")
    check(np.array_equal(engine.classify(f"{arch}/restored", vx).predictions, want),
          "the restored servable classifies differently")
    print(f"[image] register image {len(blob)} bytes; unpack_model -> register -> fused: same "
          f"predictions; save_servable -> restore_servable: same predictions and digest "
          f"{servable.version.digest}")
    trained = {"model": model, "servable": servable, "epoch": state.epoch, "vx": vx,
               "vy": vy, "want": want}
    return launches, fit_launches, trained


def tm_resume_card_to_cpu(dev, card: str) -> None:
    """A TM training checkpoint moves from the card to the CPU: one epoch of
    ``run_tm_training`` on the card (400 glyphs, batch 100) written with its
    key (the reference's ``uint32[2]``), resumed on the CPU to epoch 2,
    against the uninterrupted two-epoch run on the card.  The saved keys
    and cursors are equal; the models are equal, or epoch 2 replayed on
    both devices parts only at near ties of the Gumbel noise."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.checkpoint.checkpointer import restore_pytree
    from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
    from repro_torch.core.cotm import init_model
    from repro_torch.core.prng import key_from_data, prng_key
    from repro_torch.data import epoch_permutation, get_dataset
    from repro_torch.launch.train import run_tm_training
    from repro_torch.train.tm_engine import TrainerEngine

    arch, kw = "convcotm-mnist", dict(n_train=400, n_test=100, batch=100, seed=SEED + 3)
    cfg = COTM_CONFIGS[arch]

    def saved(d):
        return restore_pytree(init_model(prng_key(0), cfg), d, device="cpu")

    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
        run_tm_training(arch, epochs=1, device=dev, ckpt_dir=f"{d}/moved", **kw)
        one, _, extra1 = saved(f"{d}/moved")
        resumed = run_tm_training(arch, epochs=2, device="cpu", ckpt_dir=f"{d}/moved", **kw)
        whole = run_tm_training(arch, epochs=2, device=dev, ckpt_dir=f"{d}/whole", **kw)
        got, step, extra = saved(f"{d}/moved")
        want, _, extra_w = saved(f"{d}/whole")
    check(step == 2 and extra["key"] == extra_w["key"]
          and extra["pipeline"] == extra_w["pipeline"],
          f"resume card -> CPU: key or cursor {extra} != {extra_w}")
    verdict = "models equal"
    if not (torch.equal(got.ta_state, want.ta_state) and torch.equal(got.weights,
                                                                      want.weights)):
        tx, ty, _, _, _ = get_dataset("mnist", n_train=400, n_test=100)
        ds = TrainerEngine(cfg, batch_size=100, device="cpu").prepare(
            tx, ty, booleanize_method=BOOLEANIZE_METHOD[arch])
        idx = torch.from_numpy(epoch_permutation(kw["seed"], 1, 400).reshape(4, 100)
                               .astype("int64"))
        k = key_from_data(extra1["key"])
        part = _first_parting(cfg, ds.literals, ds.labels, idx, one, k.to(dev), k, dev,
                              torch.device("cpu"))
        check(part is not None and part[1] > 0 and part[2] <= 2,
              f"resume card -> CPU: models part: {part}")
        verdict = (f"models part in epoch 2 at step {part[0]}: {part[1]} patch choices flip "
                   f"where the noise is {part[2]:.2f} ulp apart at its logs")
    print(f"[train] checkpoint card -> CPU: epoch 1 on the card, resumed on the CPU to epoch "
          f"2: saved key {extra['key']} and cursor equal to the uninterrupted card run's; "
          f"{verdict}; accuracy {resumed['accuracy']:.4f} against {whole['accuracy']:.4f} "
          f"| {card}")


def engine_lifecycle(cfg, method, pools, trained, dev) -> None:
    """[service] part 1: swap and rollback of the ``svc`` slot on the card
    (the rollback restores the very tensors it displaced: O(1), no H2D),
    and ``load_checkpoint`` of the trained model in both flavours, equal
    to its predictions."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.checkpointer import save_pytree, save_servable
    from repro_torch.serve.engine import ServingEngine

    eng = ServingEngine(max_batch=256)
    eng.register("svc", pools["a"], cfg, booleanize_method=method, path="fused")
    v1 = eng.version("svc")
    ptr = eng.servable("svc").include_packed.data_ptr()
    v2 = eng.swap("svc", pools["b"], cfg)
    swapped = eng.servable("svc").include_packed
    check(swapped.device == dev and swapped.data_ptr() != ptr,
          f"swap installed an image on {swapped.device} at the old address")
    v3 = eng.rollback("svc")
    check(eng.servable("svc").include_packed.data_ptr() == ptr,
          "rollback did not restore the displaced tensors (not O(1))")
    check((v1.version, v2.version, v3.version) == (1, 2, 3) and v3.digest == v1.digest
          and v2.digest != v1.digest, f"stamps {v1} {v2} {v3}")
    print(f"[service] engine lifecycle on the card: register v1 ({v1.digest}) -> swap v2 "
          f"({v2.digest}) -> rollback v3 ({v3.digest}); include_packed at {ptr:#x} before "
          f"the swap and after the rollback (O(1), no H2D)")
    stamp = trained["servable"].version
    with tempfile.TemporaryDirectory() as d:
        save_pytree(trained["model"], f"{d}/model", trained["epoch"])
        save_servable(trained["servable"], f"{d}/servable", trained["epoch"])
        for flavour in ("model", "servable"):
            eng.load_checkpoint(f"trained/{flavour}", f"{d}/{flavour}", cfg,
                                booleanize_method=method, path="fused")
    for flavour in ("model", "servable"):
        res = eng.classify(f"trained/{flavour}", trained["vx"])
        check(np.array_equal(res.predictions, trained["want"]),
              f"load_checkpoint ({flavour}) classifies differently from the trained model")
        check(eng.version(f"trained/{flavour}").digest == stamp.digest,
              f"load_checkpoint ({flavour}) digest {eng.version(f'trained/{flavour}')}")
    print(f"[service] load_checkpoint of the trained model (save_pytree and save_servable): "
          f"fused predictions equal the trained model's on all {len(trained['want'])} test "
          f"images, digest {stamp.digest}")


async def _swap_storm(service, cfg, requests, rate, events):
    """Open-loop load of ``requests`` at ``rate`` with ``events`` (swap to a
    model, or ``None`` for a rollback) spread over the load; returns the
    load report, every admitted future's outcome (a TimeoutError when it
    hung), the stamps the events installed and the seconds to the last
    result."""
    import asyncio

    from repro_torch.serve.loadgen import poisson_open_loop

    loop = asyncio.get_running_loop()
    await service.start()
    t0 = loop.time()
    load = asyncio.create_task(poisson_open_loop(service, "svc", requests, rate, seed=SEED))
    gap = len(requests) / rate / (len(events) + 1)
    stamps = []
    for model in events:
        await asyncio.sleep(gap)
        stamps.append(await (service.rollback("svc") if model is None
                             else service.swap("svc", model, cfg)))
    report = await load
    t_load = loop.time() - t0
    outcomes = await asyncio.gather(
        *(asyncio.wait_for(asyncio.shield(f), 60.0) for _, f in report.admitted),
        return_exceptions=True)
    wall = loop.time() - t0
    await service.stop(drain=True)
    return report, outcomes, stamps, t_load, wall


def service_swap_storm(cfg, method, pools, registry, card) -> dict:
    """[service] part 2: ``ServingService`` over the ``svc`` slot under
    4,096 single-image raw requests at an offered 5,000 req/s, with 8 swaps
    alternating between the two pools and one rollback landing meanwhile.
    Every result equals a direct classify, on a second engine, of the pool
    its version's digest names; no microbatch holds two versions; nothing
    hangs; ingress_pack and fused_infer launch once per engine slice.
    The drive runs under ``torch.profiler``, whose CUDA trace covers every
    thread, and ``engine.dispatch`` is timed around each call on the
    dispatch thread, which splits the wall time per microbatch into the
    card's busy time (kernels and copies, the swaps' included) and the
    dispatch's host time.  Returns the drive's launch counts."""
    import asyncio
    import collections

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.service import ServiceConfig, ServingService

    eng = ServingEngine(max_batch=256)
    eng.register("svc", pools["a"], cfg, booleanize_method=method, path="fused")
    eng.warmup("svc")
    v1 = eng.version("svc")
    spent = []
    dispatch = eng.dispatch

    def timed_dispatch(*args, **kw):
        t = time.perf_counter()
        handle = dispatch(*args, **kw)
        spent.append(time.perf_counter() - t)
        return handle

    eng.dispatch = timed_dispatch
    rng = np.random.default_rng(SEED + 11)
    images = rng.integers(0, 256, (4096, 28, 28), dtype=np.uint8)
    requests = [images[i : i + 1] for i in range(len(images))]
    events = [pools["b"], pools["a"], pools["b"], pools["a"], None,
              pools["b"], pools["a"], pools["b"], pools["a"]]
    direct = ServingEngine(max_batch=256)
    want = {}
    for key in ("a", "b"):
        direct.register(key, pools[key], cfg, booleanize_method=method, path="fused")
        want[direct.version(key).digest] = direct.classify(key, images)
    check(not np.array_equal(*(w.predictions for w in want.values())),
          "the two pools predict alike: a swap would not show")
    service = ServingService(eng, ServiceConfig(max_delay_us=200.0))
    registry.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        report, outcomes, stamps, t_load, wall = asyncio.run(
            _swap_storm(service, cfg, requests, 5000.0, events))
    launches = registry.launch_counts()
    digests = {v1.version: v1.digest, **{s.version: s.digest for s in stamps}}
    check(len(stamps) == 9 and [s.version for s in stamps] == list(range(2, 11)),
          f"lifecycle events installed {[s.version for s in stamps]}")
    hung = sum(isinstance(o, asyncio.TimeoutError) for o in outcomes)
    failed = [o for o in outcomes if isinstance(o, BaseException)]
    check(hung == 0 and not failed and report.rejected == 0
          and len(report.admitted) == len(requests),
          f"swap storm: hung {hung}, failed {failed[:3]}, rejected {report.rejected}")
    by_batch = collections.defaultdict(set)
    seen = collections.Counter()
    for (i, _), res in zip(report.admitted, outcomes):
        w = want[digests[res.version]]
        check(np.array_equal(res.predictions, w.predictions[i : i + 1])
              and np.array_equal(res.class_sums, w.class_sums[i : i + 1]),
              f"request {i} (v{res.version}) differs from a direct classify of its version")
        by_batch[res.batch_id].add(res.version)
        seen[res.version] += 1
    check(all(len(v) == 1 for v in by_batch.values()), "a microbatch holds two versions")
    st = service.stats("svc")
    slices = sum(h["batches"] for h in st.occupancy_hist.values())
    check(launches["ingress_pack"] == launches["fused_infer"] == slices > 0,
          f"launches {launches} != {slices} engine slices")
    print(f"[service] swap storm: {len(requests)} single-image raw requests at an offered "
          f"5,000 req/s ({len(requests) / t_load:.1f} req/s submitted, "
          f"{st.completed / wall:.1f} req/s completed), 8 swaps and 1 rollback (v2..v10); "
          f"every result == a direct classify of its version; {len(by_batch)} microbatches, "
          f"each on one version; results per version {dict(sorted(seen.items()))}; hung {hung}")
    print(f"[service] swap storm latency p50 {st.p50_latency_us:.1f} us, p99 "
          f"{st.p99_latency_us:.1f} us; mean occupancy {st.mean_occupancy:.4f}; occupancy "
          f"{st.occupancy_hist}; split ingress {st.ingress_us_per_image:.2f} / device "
          f"{st.device_us_per_image:.2f} us/img | {card}")
    print(f"[service] launches during the swap storm: {launches} ({slices} engine slices)")
    n = st.batches
    check(len(spent) == n, f"{len(spent)} dispatches for {n} microbatches")
    on_card = device_rows(prof.key_averages())
    busy = sum(self_dev_us(e) for e in on_card)
    wall_us, host = wall * 1e6, sum(spent) * 1e6
    device = (f"device busy {busy / n:.1f} us/microbatch ({100 * busy / wall_us:.2f}% of "
              f"wall), idle {100 * (1 - busy / wall_us):.2f}%" if busy
              else "device busy not measured (the profiler captured no device time)")
    print(f"[profile] service swap storm: {n} microbatches ({len(requests) / n:.2f} images "
          f"each): wall {wall_us / n:.1f} us/microbatch; {device}; engine.dispatch on the "
          f"dispatch thread {host / n:.1f} us/microbatch ({100 * host / wall_us:.1f}% of "
          f"wall) | {card}")
    print_top_device("service swap storm", on_card, n, "microbatch")
    return launches


async def _chaos(service, requests, imgs):
    from repro_torch.serve.faults import chaos_soak

    await service.start()
    tally = await chaos_soak(service, "chaos", requests, 2000.0, seed=SEED,
                             malformed_frac=0.05, abandon_frac=0.05, gather_timeout_s=60.0)
    after = await service.submit("chaos", imgs)
    await service.stop(drain=True)
    return tally, after


def service_chaos(cfg, method, pools, cpu, registry, card) -> dict:
    """[service] part 3: ``chaos_soak`` (512 single-image raw requests at
    2,000 req/s, 5% malformed, 5% abandoned) against a service whose engine
    fails its 9th to 11th dispatches, one request per microbatch so each
    failure feeds the breaker: at ``failure_threshold`` 3 it steps
    ``fused -> matmul``.  No future hangs; fused_infer launched before the
    trip and never after; a request after the trip equals the CPU plain
    composition.  Returns the launch counts."""
    import asyncio

    import numpy as np

    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.faults import DegradationPolicy, FaultPlan
    from repro_torch.serve.service import ServiceConfig, ServingService

    plan = FaultPlan(engine_error_at=(9, 10, 11))
    eng = ServingEngine(max_batch=256, faults=plan)
    eng.register("chaos", pools["a"], cfg, booleanize_method=method, path="fused")
    eng.warmup("chaos")
    cpu.register("chaos", pools["a"], cfg, booleanize_method=method, path="fused")
    at_trip = []
    degrade = eng.degrade_path

    def degrade_and_note(name):
        at_trip.append(registry.launch_counts())
        return degrade(name)

    eng.degrade_path = degrade_and_note
    rng = np.random.default_rng(SEED + 12)
    requests = list(rng.integers(0, 256, (512, 1, 28, 28), dtype=np.uint8))
    imgs = rng.integers(0, 256, (64, 28, 28), dtype=np.uint8)
    service = ServingService(eng, ServiceConfig(max_delay_us=200.0, max_coalesce=1),
                             faults=plan, policy=DegradationPolicy(failure_threshold=3))
    registry.reset_launches()
    tally, after = asyncio.run(_chaos(service, requests, imgs))
    launches = registry.launch_counts()
    health = tally["health"]
    print(f"[service] chaos soak: {tally} | {card}")
    check(tally["hung"] == 0, f"chaos soak: {tally['hung']} futures hung")
    check(tally["ok"] + tally["expired"] + tally["faulted"] + tally["stopped"]
          == tally["admitted"] + tally["abandoned"] and tally["faulted"] == 3
          and tally["malformed"] > 0 and tally["abandoned"] > 0,
          f"chaos soak tally {tally}")
    check(len(at_trip) == 1 and health["fallback_path"] == "matmul"
          and eng.stats("chaos").fallback_path == "matmul"
          and eng.stats("chaos").degrade_steps == 1, f"breaker: health {health}")
    before = at_trip[0]
    check(before["fused_infer"] > 0 and launches["fused_infer"] == before["fused_infer"],
          f"fused_infer launches: {before['fused_infer']} before the trip, "
          f"{launches['fused_infer']} at the end")
    want = cpu.classify("chaos", imgs)
    check(np.array_equal(after.predictions, want.predictions)
          and np.array_equal(after.class_sums, want.class_sums),
          "after the trip the service differs from the CPU plain composition")
    print(f"[service] breaker: fused -> matmul after 3 injected engine errors (health "
          f"{health['state']}); launches at the trip {before}, at the end {launches}; a "
          f"64-image request after the trip == plain (CPU)")
    return launches


def lifecycle_round(cfg, method, trained, registry, card) -> dict:
    """[service] part 4: one ``LifecycleDriver.run_round`` on the card:
    train 1 epoch of 4,000 glyphs from the initial model, shadow the
    candidate on ``fused`` against the live version on 256 test images,
    gate, promote (checkpointed) or reject.  Returns the launch counts."""
    import tempfile

    import torch

    from repro_torch.core.prng import prng_key
    from repro_torch.data import synthetic_glyphs
    from repro_torch.launch.lifecycle import LifecycleConfig, LifecycleDriver
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.tm_engine import TrainerEngine

    tx, ty, _, _ = synthetic_glyphs(n_train=4000, n_test=0, seed=SEED + 13)
    trainer = TrainerEngine(cfg, batch_size=100)
    model = trainer.init_model(prng_key(SEED))
    eng = ServingEngine(max_batch=256)
    eng.register("life", trainer.freeze_servable(model), booleanize_method=method,
                 path="fused")
    with tempfile.TemporaryDirectory() as d:
        driver = LifecycleDriver(trainer, eng, "life",
                                 config=LifecycleConfig(min_agreement=0.0, shadow_requests=256),
                                 ckpt_dir=d, booleanize_method=method, eval_path="fused")
        registry.reset_launches()
        t = time.perf_counter()
        _, model, state, rep = driver.run_round(
            prng_key(SEED, trainer.device), model, trainer.prepare(tx, ty), trained["vx"],
            trained["vy"], epochs=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = registry.launch_counts()
        saved = sorted(os.listdir(d))
    check(rep.n == 256 and state.epoch == 1 and launches["fused_infer"] > 0,
          f"lifecycle round: report {rep}, launches {launches}")
    if rep.promoted:
        check(eng.version_id("life") == rep.promoted_version == 2
              and eng.version("life").digest == rep.candidate_digest
              and saved == ["step_00000002"], f"promotion: {eng.version('life')}, {saved}")
    else:
        check(eng.version_id("life") == 1 and not saved, "a rejected candidate was installed")
    print(f"[service] lifecycle round on the card ({dt:.3f} s: 1 epoch of 4,000 glyphs, "
          f"shadow on fused over 256 test images): {rep.as_dict()} | {card}")
    print(f"[service] launches during the lifecycle round: {launches}")
    return launches


def autotune_serving(cfg, method, pools, cpu, registry, card):
    """[autotune] part 1: ``convcotm-mnist`` on the few40 pool (C_a = 88)
    through ``ServingEngine(autotune=True)`` on ``fused``: warmup tunes
    buckets 1 and 256 in both forms, sweeping the kernel paths at every
    ``block_c``/``csrf`` set.  Each measured kernel candidate must launch
    its tile kernel on every call of its timing; the tuned engine's results
    must equal an untuned ``fused`` engine's and the CPU's on 256 images
    and on one, raw and literals; a second registration must give the same
    plan.  Returns the tuned engine, its launch counts (the counters set to
    0 before the warmup, read after the checks) and the per-candidate
    launches of the sweep."""
    import numpy as np

    from repro_torch.serve import autotune as at
    from repro_torch.serve.engine import ServingEngine

    arch = "convcotm-mnist"
    swept = {}
    measure = at._measure

    def counted(servable, name, params, form, bucket, ingress, *, repeats, **kw):
        before = registry.launch_counts()
        sec = measure(servable, name, params, form, bucket, ingress, repeats=repeats, **kw)
        after = registry.launch_counts()
        swept[name, params, form, bucket] = {k: after[k] - before[k] for k in after}
        return sec

    at._measure = counted
    try:
        at.clear_measure_memo()
        eng = ServingEngine(max_batch=256, autotune=True)
        eng.register(arch, pools["few40"], cfg, booleanize_method=method, path="fused")
        registry.reset_launches()
        t = time.perf_counter()
        eng.warmup(arch)
        warm_s = time.perf_counter() - t
        report = eng.stats(arch).autotune
        plan = eng.servable(arch).tuned
        check({(f, b) for f, b, _, _ in plan.entries}
              == {("literals", 1), ("literals", 256), ("raw", 1), ("raw", 256)},
              f"plan cells {plan.entries}")
        for row in report["rows"]:
            cands = "; ".join(f"{c['path']}{tuple(map(tuple, c['params'])) or ''} "
                              f"{c['us_per_call']:.1f}" for c in row["candidates"])
            print(f"[autotune] {row['form']} bucket {row['bucket']}: winner {row['winner']} "
                  f"params {row['params']} ({row['us_per_call']:.1f} us/call); candidates "
                  f"(us/call): {cands}")
        print(f"[autotune] sweep total_s {report['total_s']:.3f} (warmup {warm_s:.3f} s, "
              f"{len(swept)} candidates timed, repeats 3) | {card}")
        # Every kernel candidate launched its tile kernel on each of its
        # 4 calls (one warm, 3 timed); no plain candidate launched one.
        for (name, params, form, bucket), moved in swept.items():
            kernel = PATH_KERNEL.get(name)
            for k in PATH_KERNEL.values():
                want = 4 if k == kernel else 0
                check(moved[k] == want, f"sweep: {name} {params} {form} bucket {bucket} "
                      f"launched {k} {moved[k]} times, not {want}")
        for name in PATH_KERNEL:
            for params in at.sp.get_path(name).tunable:
                check(any(key[:2] == (name, params) for key in swept),
                      f"sweep: {name} {params} was not timed")

        ref = ServingEngine(max_batch=256)
        ref.register(arch, pools["few40"], cfg, booleanize_method=method, path="fused")
        cpu.register(f"{arch}/autotune", pools["few40"], cfg, booleanize_method=method,
                     path="fused")
        rng = np.random.default_rng(SEED + 17)
        for n in (256, 1):
            imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
            for ingress in ("device", "host"):
                got = eng.classify(arch, imgs, ingress=ingress)
                check(same_result(got, ref.classify(arch, imgs, ingress=ingress))
                      and same_result(got, cpu.classify(f"{arch}/autotune", imgs,
                                                        ingress=ingress)),
                      f"tuned engine ({n} images, ingress {ingress}) differs from the "
                      f"untuned fused engine or the CPU")
                check(n == 1 or bool(got.class_sums.any()), "tuned engine: class sums all 0")
        launches = registry.launch_counts()
        n_swept = len(swept)
        again = ServingEngine(max_batch=256, autotune=True)
        again.register(arch, pools["few40"], cfg, booleanize_method=method, path="fused")
        again.warmup(arch, buckets=[1, 256])
        check(again.servable(arch).tuned == plan and len(swept) == n_swept,
              "a second registration gave another plan")
    finally:
        at._measure = measure
    print(f"[autotune] tuned engine == untuned fused engine == plain (CPU) on 256 images "
          f"and on one, raw and literals; plan {[list(e) for e in plan.entries]} "
          f"(digest {plan.digest}); re-registration: the same plan")
    print(f"[autotune] launches during the tuned drive (sweep and checks): {launches}")
    return eng, launches


def autotune_lifecycle(cfg, method, pools, eng, trained, card) -> None:
    """[autotune] part 2: the plan through the lifecycle on the card.
    ``swap(retune=True)`` onto the few pool gives a plan with the new
    version's digest; ``rollback`` restores the earlier plan; a
    ``save_servable``/``restore_servable`` round trip keeps it; a plan
    stamped for another device restores as None and an armed engine
    re-tunes at warmup; a lifecycle round with ``autotune_candidate``
    promotes the candidate with its own plan."""
    import tempfile

    import torch

    from repro_torch.checkpoint.checkpointer import restore_servable, save_servable
    from repro_torch.core.prng import prng_key
    from repro_torch.data import synthetic_glyphs
    from repro_torch.launch.lifecycle import LifecycleConfig, LifecycleDriver
    from repro_torch.serve.autotune import TunedPlan
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.tm_engine import TrainerEngine

    arch = "convcotm-mnist"
    plan1 = eng.servable(arch).tuned
    v2 = eng.swap(arch, pools["few"], cfg, retune=True)
    plan2 = eng.servable(arch).tuned
    check(plan2.digest == v2.digest != plan1.digest, f"retune: plan {plan2.digest}, "
          f"version {v2.digest}, earlier {plan1.digest}")
    v3 = eng.rollback(arch)
    check(eng.servable(arch).tuned == plan1 and v3.digest == plan1.digest,
          "rollback did not restore the earlier plan")
    with tempfile.TemporaryDirectory() as d:
        save_servable(eng.servable(arch), d, v3.version)
        restored, _ = restore_servable(cfg, d)                  # the card
        check(restored.tuned == plan1, f"checkpoint round trip: {restored.tuned}")
        manifest = Path(d) / f"step_{v3.version:08d}" / "manifest.json"
        doc = json.loads(manifest.read_text())
        stamp = doc["extra"]["tuned_plan_device"]
        check(stamp == torch.cuda.get_device_name(0), f"plan stamped {stamp!r}")
        # The same model with an all-dense plan stamped for another card.
        foreign = TunedPlan(digest=plan1.digest)
        for f, b, _, _ in plan1.entries:
            foreign = foreign.with_entry(f, b, "dense", ())
        doc["extra"].update(tuned_plan=foreign.to_json(), tuned_plan_device="another card")
        manifest.write_text(json.dumps(doc))
        check(restore_servable(cfg, d)[0].tuned is None, "a foreign plan was restored")
        armed = ServingEngine(max_batch=256, autotune=True)
        armed.load_checkpoint(arch, d, cfg, booleanize_method=method, path="fused")
    check(armed.servable(arch).tuned is None, "load_checkpoint applied a foreign plan")
    armed.warmup(arch, buckets=[1, 256])
    check(armed.servable(arch).tuned == plan1 and bool(armed.stats(arch).autotune),
          f"the foreign plan was not re-tuned: {armed.servable(arch).tuned}")
    print(f"[autotune] swap(retune=True) onto the few pool: plan digest {plan2.digest} == "
          f"v{v2.version}'s; rollback restores plan {plan1.digest}; save/restore_servable on "
          f"the card keeps it (stamped {stamp!r}); a plan stamped for another card restores "
          f"as None and is re-tuned at warmup")

    tx, ty, _, _ = synthetic_glyphs(n_train=1000, n_test=0, seed=SEED + 19)
    trainer = TrainerEngine(cfg, batch_size=100)
    model = trainer.init_model(prng_key(SEED))
    life = ServingEngine(max_batch=256)
    life.register("life", trainer.freeze_servable(model), booleanize_method=method,
                  path="fused")
    driver = LifecycleDriver(trainer, life, "life", config=LifecycleConfig(
        min_agreement=0.0, allow_accuracy_drop=1.0, shadow_requests=256,
        autotune_candidate=True), booleanize_method=method, eval_path="fused")
    t = time.perf_counter()
    *_, rep = driver.run_round(prng_key(SEED, trainer.device), model,
                               trainer.prepare(tx, ty), trained["vx"], trained["vy"], epochs=1)
    dt = time.perf_counter() - t
    live = life.servable("life").tuned
    check(rep.promoted and live is not None and live.digest == rep.candidate_digest
          == life.version("life").digest, f"autotuned round: {rep}, plan {live}")
    print(f"[autotune] lifecycle round with autotune_candidate ({dt:.3f} s, 1 epoch of "
          f"1,000 glyphs): promoted v{rep.promoted_version} with the shadow slot's plan "
          f"{[list(e) for e in live.entries]} (digest {live.digest} == the candidate's) | "
          f"{card}")


def roofline_lines(cfg, eng, imgs256, img1, ops_per_s, card) -> None:
    """[roofline]: each winner of the tuned engine's plan against its
    ceiling at the card's rates, with the cls/s of the tuned classify in
    its form (raw pixels, or preprocessed literals) at its bucket; an
    achieved fraction above 1.05 means the cost model or the timer is
    wrong."""
    from repro_torch.roofline import tm_path_roofline

    arch = "convcotm-mnist"
    servable = eng.servable(arch)
    for form, bucket, path, params in servable.tuned.entries:
        imgs = imgs256 if bucket == 256 else img1
        x, kw = (eng.preprocess(arch, imgs), {"preprocessed": True}) if form == "literals" \
            else (imgs, {})
        eng.classify(arch, x, **kw)
        n_iter = 50 if bucket == 256 else 200
        t = time.perf_counter()
        for _ in range(n_iter):
            eng.classify(arch, x, **kw)
        cls_per_s = bucket * n_iter / (time.perf_counter() - t)
        r = tm_path_roofline(cfg, path, bucket, n_active=servable.sparsity.n_active,
                             measured_cls_per_s=cls_per_s, ops_per_s=ops_per_s,
                             bytes_per_s=HBM_BYTES_PER_S)
        print(f"[roofline] {form} bucket {bucket}: {path} {list(map(list, params))}: ops "
              f"{r['ops']:.6g}, bytes {r['bytes']:.6g}, bound {r['bound']} "
              f"({max(r['compute_s'], r['memory_s']) * 1e6:.4f} us), ceiling "
              f"{r['ceiling_cls_per_s']:.6g} cls/s, measured {cls_per_s:.6g} cls/s, "
              f"achieved_fraction {r['achieved_fraction']:.6g} | {card}")
        check(r["achieved_fraction"] <= 1.05,
              f"{path} at bucket {bucket}: achieved fraction {r['achieved_fraction']}")


#: The meshes of the [mesh] phase, all on cuda:0 repeated: (label, data,
#: model, clause-sharded).
MESHES = (("data 1", 1, 1, False), ("data 2", 2, 1, False), ("data 4", 4, 1, False),
          ("model 2", 1, 2, True), ("model 4", 1, 4, True), ("2x2", 2, 2, True))
MESH_PATHS = ("fused", "kernel")
#: Request forms: raw pixels, the host ingress, preprocessed literals.
MESH_FORMS = ("raw", "host", "preprocessed")


def _classify_form(eng, name, imgs, form):
    if form == "raw":
        return eng.classify(name, imgs)
    if form == "host":
        return eng.classify(name, imgs, ingress="host")
    return eng.classify(name, eng.preprocess(name, imgs), preprocessed=True)


@contextlib.contextmanager
def _clause_widths(ops, seen: set):
    """Record (kernel, clauses) of every fused_infer and clause_eval launch
    in the window (the wrappers still count their launches)."""
    saved = ops.fused_infer_cuda, ops.clause_eval_cuda

    def rec(kernel, fn):
        def wrapped(lit, inc, *a, **kw):
            seen.add((kernel, inc.shape[0]))
            return fn(lit, inc, *a, **kw)
        return wrapped

    ops.fused_infer_cuda = rec("fused_infer", saved[0])
    ops.clause_eval_cuda = rec("clause_eval", saved[1])
    try:
        yield seen
    finally:
        ops.fused_infer_cuda, ops.clause_eval_cuda = saved


def _mesh_engine(dev, d, m, sc, **kw):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.mesh import ServeMesh

    return ServingEngine(max_batch=256, mesh=ServeMesh(make_test_mesh(d, m, device=dev), sc),
                         **kw)


def mesh_serving(cfg, method, pools, cpu, registry, dev, card) -> dict:
    """[mesh] part 1: ``convcotm-mnist`` at full width on meshes of cuda:0
    repeated (replicated data 1, 2, 4; clause-sharded model 2, 4 and 2x2)
    on ``fused`` and ``kernel``, boundary and few40 pools, requests of 1,
    13 and 256 raw images in the three forms.  Every result equals the
    unmeshed engine's on the card, which equals the plain composition on
    the CPU; each mesh's drive is a launch window of its own, whose
    ingress_pack launches are one per data shard and raw request and
    whose tile-kernel launches one per (data, model) shard and request.
    Then C=1000 (Table III's clause count) at the paper's patch geometry,
    clause-sharded over 4 (shards of 250).  Times classify at bucket 256
    and 1 for data 1, 2, 4 and model 2 ("shards on one card"), in turns
    with the unmeshed engine.  Returns the launch counts of the meshed
    drives."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServingEngine

    rng = np.random.default_rng(SEED + 18)
    requests = [rng.integers(0, 256, (n, 28, 28), dtype=np.uint8) for n in (1, 13, 256)]
    one = ServingEngine(max_batch=256)
    names = [(pool, path) for pool in ("boundary", "few40") for path in MESH_PATHS]
    want = {}
    for pool, path in names:
        name = f"{pool}/{path}"
        one.register(name, pools[pool], cfg, booleanize_method=method, path=path)
        cpu.register(f"mesh/{name}", pools[pool], cfg, booleanize_method=method, path=path)
        for i, r in enumerate(requests):
            for form in MESH_FORMS:
                res = want[name, i, form] = _classify_form(one, name, r, form)
                check(same_result(res, _classify_form(cpu, f"mesh/{name}", r, form)),
                      f"[mesh] unmeshed {name} ({len(r)} images, {form}) differs from the CPU")
    check(bool(want["few40/fused", 2, "raw"].class_sums.any()), "few40: all class sums 0")
    print(f"[mesh] unmeshed engine on the card == plain (CPU): {len(names)} registrations "
          f"(boundary/few40 x fused/kernel), requests of 1, 13, 256 images, forms "
          f"{list(MESH_FORMS)}")

    totals = dict.fromkeys(registry.KERNELS, 0)
    widths: set = set()
    imgs256, img1 = requests[2], requests[0]
    timed = {}
    for label, d, m, sc in MESHES:
        eng = _mesh_engine(dev, d, m, sc)
        for pool, path in names:
            eng.register(f"{pool}/{path}", pools[pool], cfg, booleanize_method=method,
                         path=path)
        shards = eng.servable("boundary/fused").placement.shards
        registry.reset_launches()
        with _clause_widths(ops, widths):
            got = {(f"{p}/{q}", i, form): _classify_form(eng, f"{p}/{q}", r, form)
                   for p, q in names for i, r in enumerate(requests) for form in MESH_FORMS}
        launches = registry.launch_counts()
        for key, res in got.items():
            check(same_result(res, want[key]), f"[mesh] {label}: {key} differs from the "
                  f"unmeshed engine")
        per = d * (m if sc else 1)            # tile launches a classify
        n_req = len(requests) * len(MESH_FORMS) * 2                  # x 2 pools
        expect = {"ingress_pack": d * len(requests) * 2 * len(MESH_PATHS),
                  "fused_infer": per * n_req, "clause_eval": per * n_req}
        for k, v in launches.items():
            check(v == expect.get(k, 0), f"[mesh] {label}: {k} launched {v} times, not "
                  f"{expect.get(k, 0)}")
            totals[k] += v
        print(f"[engine] launches during the {label} mesh drive "
              f"({'clause-sharded' if sc else 'replicated'}, {d}x{m} of cuda:0; shard "
              f"widths {sorted({s.n_clauses for row in shards for s in row})} clauses): "
              f"{launches}")
        if label in ("data 1", "data 2", "data 4", "model 2"):
            timed[label] = eng
    print(f"[mesh] {len(MESHES)} meshes ({', '.join(x[0] for x in MESHES)}) x "
          f"{list(MESH_PATHS)} x 2 pools x requests of 1, 13, 256 x {list(MESH_FORMS)}: "
          f"every result == the unmeshed engine (card) == plain (CPU)")

    # Table III's clause count: shards of 250, not a multiple of a tile.
    cfg3 = dataclasses.replace(cfg, n_clauses=1000)
    g = torch.Generator().manual_seed(SEED + 19)
    ta = torch.where(torch.rand((1000, cfg.n_literals), generator=g) < 3.0 / cfg.n_literals,
                     133, 123).to(torch.uint8)
    w = torch.randint(-127, 128, (cfg.n_classes, 1000), generator=g, dtype=torch.int32)
    m3 = type(pools["few40"])(ta_state=ta, weights=w)
    eng = _mesh_engine(dev, 1, 4, True)
    for path in MESH_PATHS:
        one.register(f"t3/{path}", m3, cfg3, booleanize_method=method, path=path)
        eng.register(f"t3/{path}", m3, cfg3, booleanize_method=method, path=path)
        cpu.register(f"mesh/t3/{path}", m3, cfg3, booleanize_method=method, path=path)
    registry.reset_launches()
    with _clause_widths(ops, widths):
        got = {(path, i, form): _classify_form(eng, f"t3/{path}", r, form)
               for path in MESH_PATHS for i, r in enumerate(requests[1:])
               for form in MESH_FORMS}
    launches = registry.launch_counts()
    for (path, i, form), res in got.items():
        r = requests[1 + i]
        ref = _classify_form(one, f"t3/{path}", r, form)
        check(same_result(res, ref), f"[mesh] Table III {path} ({len(r)} images, {form}): "
              f"model 4 differs from the unmeshed engine")
        if form == "raw":
            check(same_result(res, cpu.classify(f"mesh/t3/{path}", r)),
                  f"[mesh] Table III {path} ({len(r)} images): differs from the CPU")
    check(bool(got["fused", 1, "raw"].class_sums.any()), "Table III: all class sums 0")
    check(launches["fused_infer"] == launches["clause_eval"] == 4 * 2 * len(MESH_FORMS),
          f"[mesh] Table III launches {launches}")
    for k, v in launches.items():
        totals[k] += v
    print(f"[engine] launches during the Table III (C=1000) model-4 drive: {launches}")
    seen = {k: sorted(c for kk, c in widths if kk == k) for k in ("fused_infer", "clause_eval")}
    for kernel, cs in seen.items():
        check({32, 64, 250} <= set(cs), f"[mesh] {kernel} ran on clause widths {cs}")
    print(f"[mesh] clause widths the tile kernels ran on: {seen}; Table III (C=1000) model 4 "
          f"== unmeshed (card) == plain (CPU, raw) on 13 and 256 images")
    # In turns with the unmeshed engine (unmeshed, mesh, mesh, unmeshed):
    # host-clock readings drift within a call.
    for label, eng in timed.items():
        turns = {"mesh": [], "none": []}
        for who in ("none", "mesh", "mesh", "none"):
            turns[who].append(classify_stats(eng if who == "mesh" else one,
                                             "boundary/fused", imgs256, img1))
        (ms, med, _), (ms0, med0, _) = (
            [statistics.mean(x[i] for x in turns[w]) for i in range(3)] for w in ("mesh", "none"))
        print(f"[time] classify fused (boundary pool), {label}, shards on one card: bucket 256 "
              f"{ms:.4f} ms per request (no mesh {ms0:.4f} ms in turns, x{ms / ms0:.2f}); "
              f"bucket 1 median {med:.1f} us (no mesh {med0:.1f} us, x{med / med0:.2f}); turns "
              f"{[f'{x[0]:.4f} ms {x[1]:.1f} us' for x in turns['mesh']]} and "
              f"{[f'{x[0]:.4f} ms {x[1]:.1f} us' for x in turns['none']]} | {card}")
    return totals


async def _mesh_service_load(service, requests, burst):
    """Sequential requests (each a microbatch of its own), then a burst of
    single images; returns (shards after each sequential request, results,
    burst results, hung)."""
    import asyncio

    await service.start()
    shards, results = [], []
    for r in requests:
        results.append(await asyncio.wait_for(service.submit("svc", r), 60))
        shards.append(service.engine.data_shards)
    futs = [asyncio.ensure_future(service.submit("svc", b)) for b in burst]
    done, pending = await asyncio.wait(futs, timeout=60)
    await service.stop(drain=True)
    return shards, results, [f.result() for f in futs if f in done], len(pending)


def mesh_service_and_tuning(cfg, method, pools, registry, dev, card) -> dict:
    """[mesh] part 2: ``ServingService`` over a data-4 engine on cuda:0
    repeated whose FaultPlan loses a device at the first two microbatches:
    the mesh shrinks 4 -> 2 -> 1, every result equals the unmeshed
    engine's classify of the same version, nothing hangs.  ``--mesh 2``
    is refused on a one-card machine.  Then one tuned registration on a
    data-2 mesh (``autotune=True``): its plan holds default parameters
    only, and it equals the unmeshed engine.  Returns the launch counts."""
    import asyncio

    import numpy as np

    import torch

    from repro_torch.launch.serve import parse_serve_mesh
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.service import ServiceConfig, ServingService

    one = ServingEngine(max_batch=256)
    one.register("svc", pools["few40"], cfg, booleanize_method=method, path="fused")
    plan = FaultPlan(device_loss_at=(1, 2))
    eng = _mesh_engine(dev, 4, 1, False)
    eng.register("svc", pools["few40"], cfg, booleanize_method=method, path="fused")
    rng = np.random.default_rng(SEED + 20)
    seq = [rng.integers(0, 256, (n, 28, 28), dtype=np.uint8) for n in (13, 7, 256)]
    burst = list(rng.integers(0, 256, (64, 1, 28, 28), dtype=np.uint8))
    service = ServingService(eng, ServiceConfig(max_delay_us=200.0), faults=plan)
    registry.reset_launches()
    shards, results, burst_res, hung = asyncio.run(_mesh_service_load(service, seq, burst))
    launches = registry.launch_counts()
    check(hung == 0 and len(burst_res) == len(burst), f"[mesh] service: {hung} hung")
    check(shards == [2, 1, 1] and eng.stats("svc").data_shards == 1
          and service.health().device_losses == 2,
          f"[mesh] service: data shards {shards}, losses {service.health().device_losses}")
    for r, res in zip(seq + burst, results + burst_res):
        check(same_result(res, one.classify("svc", r)) and res.version == 1,
              "[mesh] service result differs from the unmeshed classify of its version")
    print(f"[mesh] service over a data-4 mesh of cuda:0 with two injected device losses: "
          f"data shards after each request {shards} (4 -> 2 -> 1), {len(seq)} requests and "
          f"a burst of {len(burst)} single images == the unmeshed classify, hung {hung}, "
          f"device losses {service.health().device_losses} | {card}")

    # --mesh 2 takes two distinct cards: on a one-card machine the
    # launcher refuses with the explicit-mesh hint, as the reference does.
    if dev.type == "cuda" and torch.cuda.device_count() == 1:
        try:
            parse_serve_mesh("2")
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "DeviceMesh" in refused,
              "--mesh 2 on a one-card machine was not refused with the hint")
        print(f"[mesh] --mesh 2 on this one-card machine: refused ({refused})")

    tuned = _mesh_engine(dev, 2, 1, False, autotune=True)
    tuned.register("svc", pools["few40"], cfg, booleanize_method=method, path="fused")
    t = time.perf_counter()
    tuned.warmup("svc", buckets=[2, 256])
    warm_s = time.perf_counter() - t
    entries = tuned.servable("svc").tuned.entries
    check(len(entries) == 4 and all(p == () for _, _, _, p in entries),
          f"[mesh] tuned meshed plan {entries}")
    for r in seq:
        for ingress in ("device", "host"):
            check(same_result(tuned.classify("svc", r, ingress=ingress),
                              one.classify("svc", r, ingress=ingress)),
                  "[mesh] tuned data-2 engine differs from the unmeshed engine")
    after = registry.launch_counts()
    print(f"[mesh] tuned data-2 registration (autotune=True, warmup {warm_s:.3f} s): plan "
          f"{[list(e) for e in entries]}; == unmeshed on {[len(r) for r in seq]} images, "
          f"raw and host")
    print(f"[engine] launches during the meshed service and tuned drives: {after}")
    return after


def mesh_training(dev, card) -> None:
    """[mesh] part 3: TrainerEngine data-parallel on data 2 and data 4
    (cuda:0 repeated), batch 100, one epoch of 4,000 glyphs from the same
    key and the same initial model:
    TA state and weights equal the unmeshed card run's."""
    import torch

    from repro_torch.configs.convcotm import COTM_CONFIGS
    from repro_torch.core.prng import prng_key
    from repro_torch.data import PipelineState, synthetic_glyphs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.tm_engine import TrainerEngine

    cfg = COTM_CONFIGS["convcotm-mnist"]
    tx, ty, _, _ = synthetic_glyphs(n_train=4000, n_test=0, seed=SEED + 21)
    out = {}
    for data in (1, 2, 4):
        mesh = None if data == 1 else make_test_mesh(data, 1, device=dev)
        trainer = TrainerEngine(cfg, batch_size=100, mesh=mesh, device=dev)
        ds = trainer.prepare(tx, ty)
        model = trainer.init_model(prng_key(SEED))
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, model, _, n = trainer.run_epoch(prng_key(SEED + 22, trainer.device), model, ds,
                                           PipelineState(seed=SEED))
        torch.cuda.synchronize()
        out[data] = (model, n, time.perf_counter() - t)
    base = out[1][0]
    check(bool((base.ta_state != 127).any()), "[mesh] training moved no TA state")
    for data in (2, 4):
        m = out[data][0]
        check(torch.equal(m.ta_state, base.ta_state) and torch.equal(m.weights, base.weights),
              f"[mesh] data-{data} trainer differs from the unmeshed one")
    print(f"[mesh] trainer data 2 and data 4 (cuda:0 repeated), 1 epoch of 4,000 glyphs at "
          f"batch 100 from the same key: ta_state and weights == unmeshed; epoch seconds "
          f"{ {k: round(v[2], 4) for k, v in out.items()} } ({out[1][1]} samples each) | "
          f"{card}")


# ---------------------------------------------------------------------------
# 5. The LM substrate's serving path ([lm] lines)
# ---------------------------------------------------------------------------

#: Logits of the card and of the CPU agree within rtol = atol = this (fp32).
LM_TOL = 1e-3
#: Decode steps of each reduced arch on both devices; h2o-danube's reduced
#: window is 16, so its 40 positions wrap the ring twice.
LM_DECODE_STEPS = 8
LM_RING_STEPS = 40
#: The 3-layer xLSTM of the reference's own stepwise test: deeper, on
#: weights of the reference's scale, the reduced xLSTM is too ill-conditioned
#: for any tolerance (tests/test_torch_lm_models.py); its 17 layers are held
#: on weights drawn with each layer's own fan-in.
XLSTM_SHALLOW = dict(n_layers=3, block_pattern=("mlstm", "slstm"))
#: Dense bf16 tensor-core FLOPs per clock per SM on an H100 (132 SMs x
#: 4,096 x 1.83 GHz boost = 989 TFLOP/s, the data sheet's dense bf16 rate).
BF16_FLOPS_PER_CLOCK_PER_SM = 4096


def lm_kda(dev, card: str) -> dict:
    """[lm kda] The KDA decode kernel at its main path's shape, then
    Kimi-Linear-48B-A3B through ``generate`` on the card (see the module
    docstring, phase 8).  Returns the kernel's row of the ``kernels``
    line."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import generate
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key
    from repro_torch.kernels import kda as kda_kernels
    from repro_torch.launch.specs import model_decls
    from repro_torch.models import transformer as tfm
    from repro_torch.models.base import init_params
    from repro_torch.train import decode_graph

    cuda, plain = kda_kernels.kda_decode_cuda, kda_kernels.kda_decode_plain
    b, h, dk = 256, 32, 128
    g = torch.Generator(device=dev).manual_seed(SEED)

    def r(*shape):
        return torch.randn(shape, device=dev, generator=g)

    q, k = (t / t.norm(dim=-1, keepdim=True) for t in (r(b, h, dk), r(b, h, dk)))
    q = q * dk ** -0.5
    v, state = r(b, h, dk), r(b, h, dk, dk)
    decay = -torch.rand((b, h, dk), device=dev, generator=g)       # exp in (e^-1, 1]
    beta = torch.rand((b, h), device=dev, generator=g)
    mine, err = state.clone(), 0.0
    for _ in range(3):
        o = cuda(mine, q, k, v, decay, beta)
        want = plain(state, q, k, v, decay, beta)
        torch.cuda.synchronize()
        check(torch.allclose(mine, state, rtol=1e-5, atol=1e-5)
              and torch.allclose(o, want, rtol=1e-5, atol=1e-5),
              f"[lm kda] kda_decode_cuda differs from kda_decode_plain at {b} x {h} x {dk} x "
              f"{dk}: state {float((mine - state).abs().max()):.3g}, o "
              f"{float((o - want).abs().max()):.3g}")
        err = max(err, float((mine - state).abs().max()), float((o - want).abs().max()))
    ms, held = time_ms(lambda: cuda(mine, q, k, v, decay, beta), inner=10)
    plain_ms, plain_held = time_ms(lambda: plain(state, q, k, v, decay, beta), inner=3,
                                   repeats=5, warmup=1)
    # Each state read and written once; q, k, g, v and beta read, o written.
    nbytes = 4 * b * h * (2 * dk * dk + 5 * dk + 1)
    flops = 8 * b * h * dk * dk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fp32_per_s = sms * max_sm_clock_mhz() * 1e6 * FP32_FLOPS_PER_CLOCK_PER_SM
    bound_ms, bound_by = bound(nbytes, flops, fp32_per_s)
    unheld = [n for n, ok in (("ms", held), ("plain_ms", plain_held)) if not ok]
    print(f"[lm kda] kda_decode_cuda == kda_decode_plain at {b} x {h} x {dk} x {dk} float32 "
          f"over 3 steps (max abs err {err:.3g}, 1e-5); kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, bound {bound_ms:.4g} ms ({bound_by}: {nbytes:,} B, {flops:,} "
          f"FLOPs at {fp32_per_s / 1e12:.1f} TFLOPS float32), {100 * bound_ms / ms:.1f}% of "
          f"the bound{f'; host gaps in {unheld}' if unheld else ''} | {card}")
    del q, k, v, state, decay, beta, mine, o, want

    # The main path: generate at the published widths on the experts the
    # benchmark's cell holds.
    cfg = dataclasses.replace(get_config("kimi-linear-48b-a3b"), n_experts_held=64,
                              first_expert_held=0)
    n_kda = tfm.layer_kinds(cfg).count("kda")
    decode_graph.drop()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(model_decls(cfg, fan_in=True), prng_key(SEED, dev))
    plen, gen = 4, 4
    prompts = torch.from_numpy(np.random.default_rng(SEED + 43).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)).to(dev)
    cuda.launches = 0
    first = generate(cfg, model, prompts, gen)
    torch.cuda.synchronize()
    launches = cuda.launches
    check(launches == 2 * n_kda,
          f"[lm kda] the first generate launched kda_decode {launches} times through its "
          f"wrapper, not {2 * n_kda} (the capture's eager step and the capture)")
    check(first.shape == (b, gen) and bool(((first >= 0) & (first < cfg.vocab_size)).all()),
          "[lm kda] generate: shape or vocab")
    replays = decode_graph.COUNTS["replays"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        second = generate(cfg, model, prompts, gen)
        torch.cuda.synchronize()
    steps = decode_graph.COUNTS["replays"] - replays
    rows = [e for e in device_rows(prof.key_averages()) if "kda_decode" in e.key]
    replayed = sum(e.count for e in rows)
    check(torch.equal(first, second), "[lm kda] generate: a second call gave other tokens")
    check(cuda.launches == launches and steps == plen + gen and replayed == steps * n_kda,
          f"[lm kda] the second generate: {cuda.launches - launches} wrapper launches, "
          f"{steps} replays, {replayed} kda_decode device rows (want 0, {plen + gen}, "
          f"{(plen + gen) * n_kda})")
    kernel_us = sum(self_dev_us(e) for e in rows) / max(replayed, 1)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[lm kda] {cfg.name} (64 of 256 experts held) generate at {b} x ({plen} + {gen}): "
          f"{launches} kda_decode launches through the wrapper in the first call "
          f"({n_kda} KDA layers: the capture's eager step and the capture); the second "
          f"call the same tokens, {steps} replays, {replayed} kda_decode device rows "
          f"({kernel_us / 1e3:.4f} ms each); memory peak {peak:,} B | {card}")
    decode_graph.drop()
    del model, first, second
    torch.cuda.empty_cache()
    return {"name": "kda_decode", "route": "cuda", "source": "src/repro_torch/csrc/kda_decode.cu",
            "replaces": None, "pool": None, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            # The second call's kda_decode rows: launched by its replays.
            "replayed_launches": replayed, "replayed_ms": kernel_us / 1e3,
            "launch_floor_ms": None, "parent_ms": None, "host_gaps_in": unheld}


def _sdpa_decode_ms(q, k, v, want, mask, unheld: list, pos: int):
    """PyTorch's one call for the same decode attention,
    ``F.scaled_dot_product_attention`` with ``enable_gqa`` and the slots'
    bool mask, under each backend that takes it: (the fastest time within
    the values' rounding of ``want`` or None, a note of each backend's
    time, refusal or miss)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, kv, g, hd = q.shape
    query = q.reshape(b, kv * g, 1, hd)
    mask = mask[None, None, None, :]

    def call():
        return F.scaled_dot_product_attention(query, k, v, attn_mask=mask, enable_gqa=True)

    best, notes = None, []
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.MATH):
        name = backend.name.lower()
        try:
            with sdpa_kernel([backend]):
                got = call().reshape(b, kv, g, hd)
                torch.cuda.synchronize()
                ms, held = time_ms(call, inner=20)
        except RuntimeError as exc:
            notes.append(f"{name} refused ({str(exc).splitlines()[0][:60]})")
            continue
        if not held:
            unheld.append(f"library {name} at {pos}")
        e = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=1.6e-2, atol=1e-2):
            notes.append(f"{name} {ms:.5f} ms but off by {e:.3g}")
            continue
        notes.append(f"{name} {ms:.5f} ms (max abs err {e:.3g})")
        best = ms if best is None else min(best, ms)
    return best, "; ".join(notes)


def lm_gqa(dev, card: str) -> dict:
    """[lm gqa] The decode step's GQA attention kernel at h2o-danube-1.8b's
    shape, then h2o-danube-1.8b through ``generate`` on the card (see the
    module docstring, phase 9).  Returns the kernel's row of the
    ``kernels`` line."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import generate
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key
    from repro_torch.kernels import gqa_decode
    from repro_torch.launch.specs import model_decls
    from repro_torch.models.base import init_params
    from repro_torch.train import decode_graph

    cuda, plain = gqa_decode.gqa_decode_cuda, gqa_decode.gqa_decode_plain
    b, kv, g, s, hd, window = 256, 8, 4, 256, 80, 4096
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
               for shape in ((b, kv, g, hd), (b, kv, s, hd), (b, kv, s, hd)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fp32_per_s = sms * max_sm_clock_mhz() * 1e6 * FP32_FLOPS_PER_CLOCK_PER_SM
    times, err, unheld = [], 0.0, []
    for pos in (15, 127, 255):
        got, want = cuda(q, k, v, pos, window), plain(q, k, v, pos, window)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), rtol=1.6e-2, atol=1e-2),
              f"[lm gqa] gqa_decode_cuda differs from gqa_decode_plain at position {pos}: "
              f"max abs err {e:.3g}")
        err = max(err, e)
        ms, held = time_ms(lambda: cuda(q, k, v, pos, window), inner=20)
        plain_ms, plain_held = time_ms(lambda: plain(q, k, v, pos, window), inner=5,
                                       repeats=5, warmup=1)
        unheld += [f"{n} at {pos}" for n, ok in (("ms", held), ("plain_ms", plain_held)) if not ok]
        library_ms, library = _sdpa_decode_ms(q, k, v, want, gqa_decode.visible(
            pos, torch.arange(s, device=dev), s, window), unheld, pos)
        # The visible slots' K and V read once; q read and the output written.
        n = pos + 1
        nbytes = 2 * b * kv * (2 * n * hd + 2 * g * hd)
        flops = 4 * b * kv * g * n * hd
        bound_ms, bound_by = bound(nbytes, flops, fp32_per_s)
        times.append({"pos": pos, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "library": library, "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": e})
        print(f"[lm gqa] gqa_decode_cuda == gqa_decode_plain at {b} x {kv} kv x {g} x {s} slots "
              f"x {hd} bf16, position {pos} (max abs err {e:.3g}; rtol 1.6e-2, atol 1e-2); "
              f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, library {library} "
              f"(F.scaled_dot_product_attention, enable_gqa, the bool mask made beforehand), "
              f"bound {bound_ms:.4g} ms ({bound_by}: {nbytes:,} B, {flops:,} FLOPs), "
              f"{100 * bound_ms / ms:.1f}% of the bound | {card}")
    del q, k, v, got, want

    # The main path: generate at the published widths, as the benchmark's cell.
    cfg = get_config("h2o-danube-1.8b")
    decode_graph.drop()
    torch.cuda.empty_cache()
    model = init_params(model_decls(cfg, fan_in=True), prng_key(SEED, dev))
    plen, new = 4, 4
    prompts = torch.from_numpy(np.random.default_rng(SEED + 44).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)).to(dev)
    cuda.launches = 0
    first = generate(cfg, model, prompts, new, max_seq=s)
    torch.cuda.synchronize()
    launches = cuda.launches
    check(launches == 2 * cfg.n_layers,
          f"[lm gqa] the first generate launched gqa_decode {launches} times through its "
          f"wrapper, not {2 * cfg.n_layers} (the capture's eager step and the capture)")
    replays = decode_graph.COUNTS["replays"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        second = generate(cfg, model, prompts, new, max_seq=s)
        torch.cuda.synchronize()
    steps = decode_graph.COUNTS["replays"] - replays
    rows = [e for e in device_rows(prof.key_averages()) if "gqa_decode" in e.key]
    replayed = sum(e.count for e in rows)
    check(torch.equal(first, second), "[lm gqa] generate: a second call gave other tokens")
    check(cuda.launches == launches and steps == plen + new
          and replayed == steps * cfg.n_layers,
          f"[lm gqa] the second generate: {cuda.launches - launches} wrapper launches, "
          f"{steps} replays, {replayed} gqa_decode device rows (want 0, {plen + new}, "
          f"{(plen + new) * cfg.n_layers})")
    kernel_us = sum(self_dev_us(e) for e in rows) / max(replayed, 1)
    print(f"[lm gqa] {cfg.name} generate at {b} x ({plen} + {new}), max_seq {s}: {launches} "
          f"gqa_decode launches through the wrapper in the first call ({cfg.n_layers} layers: "
          f"the capture's eager step and the capture); the second call the same tokens, "
          f"{steps} replays, {replayed} gqa_decode device rows ({kernel_us / 1e3:.4f} ms "
          f"each, positions 0-{plen + new - 1}) | {card}")
    decode_graph.drop()
    del model, first, second
    torch.cuda.empty_cache()
    last = times[-1]
    return {"name": "gqa_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/gqa_decode.cu", "replaces": None, "pool": None,
            "launches": launches, "max_abs_err": err, "ms": last["ms"],
            "plain_ms": last["plain_ms"], "bound_ms": last["bound_ms"],
            "bound_by": last["bound_by"], "by_position": times,
            "library_ms": last["library_ms"],
            # The second call's gqa_decode rows: launched by its replays.
            "replayed_launches": replayed, "replayed_ms": kernel_us / 1e3,
            "launch_floor_ms": None, "parent_ms": None, "host_gaps_in": unheld}


def _lm_data(cfg, seed: int) -> dict:
    """A seeded CPU batch of 2: frame embeds and 8 decoder tokens for
    encoder-decoders, 8 frontend embeds before 8 tokens for vision archs,
    16 tokens otherwise."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b, s = 2, 16

    def emb(n):
        return torch.from_numpy(rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
                                ).to(cfg.dtype)

    def toks(n):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32))

    if cfg.is_encoder_decoder:
        return {"frontend_embeds": emb(s), "dec_tokens": toks(s // 2)}
    if cfg.modality == "vision":
        return {"tokens": toks(s - 8), "frontend_embeds": emb(8)}
    return {"tokens": toks(s)}


def _lm_run(cfg, model, dev, data: dict, steps: int, feed=None):
    """``prefill`` of ``data`` and ``steps`` decode steps from an empty
    cache on ``dev``, starting from the batch's first token; each next
    token is ``feed``'s (another device's greedy tokens) or this run's own
    argmax.  Returns (prefill logits, decode logits [B, steps, V], tokens
    fed [B, steps]), on ``dev``."""
    import torch

    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tfm
    from repro_torch.train.serve_step import decode, prefill

    with torch.no_grad():
        batch = {k: v.to(dev) for k, v in data.items()}
        first = prefill(model, batch, cfg)
        b = first.shape[0]
        cross = None
        if cfg.is_encoder_decoder:
            cross = ed.prepare_cross_cache(model, ed.encode(model, batch["frontend_embeds"], cfg),
                                           cfg)
            cache = ed.init_self_cache(b, cfg, steps, dev)
            tok = batch["dec_tokens"][:, :1]
        else:
            cache = tfm.init_decode_cache(b, cfg, steps, dev)
            tok = batch["tokens"][:, :1]
        logits, fed = [], []
        for i in range(steps):
            lg, cache = decode(model, tok, cache, i, cfg, cross_cache=cross)
            logits.append(lg)
            nxt = lg.argmax(-1).to(torch.int32) if feed is None else feed[:, i].to(dev)
            fed.append(nxt)
            tok = nxt[:, None]
        return first, torch.stack(logits, 1), torch.stack(fed, 1)


def _lm_card_and_cpu(cfg, dev, steps: int, seed: int, decls=None):
    """The reduced ``cfg`` (``decls``, its ``model_decls`` by default) drawn
    on a seeded CPU generator and copied to the card; both run :func:`_lm_run` on one batch, the card fed the CPU's
    greedy tokens.  Returns the worst logit deviation (prefill and decode),
    whether all logits agree within ``LM_TOL``, the positions whose CPU
    top-2 margin exceeds ten times ``LM_TOL`` and how many of them the
    card's argmax matches, and the smallest margin."""
    import copy

    import torch

    from repro_torch.core.prng import prng_key
    from repro_torch.launch.specs import model_decls
    from repro_torch.models.base import init_params

    decls = model_decls(cfg) if decls is None else decls
    cpu_model = init_params(decls, prng_key(seed))
    card_model = copy.deepcopy(cpu_model).to(dev)
    check(all(p.device == dev for p in card_model.parameters()), f"{cfg.name}: not on {dev}")
    data = _lm_data(cfg, seed)
    cpu_first, cpu_logits, cpu_toks = _lm_run(cfg, cpu_model, "cpu", data, steps)
    card_first, card_logits, _ = _lm_run(cfg, card_model, dev, data, steps, feed=cpu_toks)
    card_first, card_logits = card_first.cpu(), card_logits.cpu()
    err = max(float((card_first - cpu_first).abs().max()),
              float((card_logits - cpu_logits).abs().max()))
    close = (torch.allclose(card_first, cpu_first, rtol=LM_TOL, atol=LM_TOL)
             and torch.allclose(card_logits, cpu_logits, rtol=LM_TOL, atol=LM_TOL)
             and bool(torch.isfinite(card_logits).all()))
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = margin > 10 * LM_TOL
    same = int((card_logits.argmax(-1) == cpu_logits.argmax(-1))[clear].sum())
    return err, close, int(clear.sum()), same, float(margin.min())


def lm_card_against_cpu(dev, card: str) -> None:
    """[lm] 1: every arch, reduced, fp32: the card against the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, paired_archs, reduced_config

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "fp32 matmuls must not run in TF32")
    print(f"[lm] fp32 matmuls: allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()!r}")
    for arch in paired_archs():
        changes = XLSTM_SHALLOW if arch == "xlstm-350m" else {}
        cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=torch.float32,
                                  **changes)
        steps = LM_RING_STEPS if cfg.sliding_window else LM_DECODE_STEPS
        err, close, n_clear, same, min_margin = _lm_card_and_cpu(cfg, dev, steps, SEED)
        what = f"{cfg.n_layers} layers" + (", 3-layer xLSTM" if changes else "")
        ring = ""
        if cfg.sliding_window:
            ring = (f", a ring of {cfg.sliding_window} over {steps} positions, "
                    f"{(steps - 1) // cfg.sliding_window} wraps")
        print(f"[lm] {arch} reduced ({what}{ring}) card == CPU: prefill + {steps} decode "
              f"steps, max |dlogit| {err:.3g} (rtol=atol={LM_TOL:g}); greedy tokens equal at "
              f"{same} of {n_clear} positions with a top-2 margin > {10 * LM_TOL:g} "
              f"(smallest margin {min_margin:.3g}) | {card}")
        check(close, f"[lm] {arch}: card and CPU logits differ by {err:.3g} > {LM_TOL:g}")
        check(n_clear > 0 and same == n_clear,
              f"[lm] {arch}: greedy tokens differ at {n_clear - same} clear positions")
    # The reduced xLSTM at its 17 layers, on weights drawn with each
    # layer's own fan-in (std 1/sqrt(d_in)).
    from repro_torch.launch.specs import model_decls

    cfg = dataclasses.replace(reduced_config(get_config("xlstm-350m")), dtype=torch.float32)
    err, close, n_clear, same, min_margin = _lm_card_and_cpu(
        cfg, dev, LM_DECODE_STEPS, SEED, model_decls(cfg, fan_in=True))
    print(f"[lm] xlstm-350m reduced ({cfg.n_layers} layers, weights of each layer's own "
          f"fan-in) card == CPU: prefill + {LM_DECODE_STEPS} decode steps, max |dlogit| "
          f"{err:.3g} (rtol=atol={LM_TOL:g}); greedy tokens equal at {same} of {n_clear} "
          f"positions with a top-2 margin > {10 * LM_TOL:g} (smallest margin "
          f"{min_margin:.3g}) | {card}")
    check(close, f"[lm] xlstm-350m 17 layers: card and CPU logits differ by {err:.3g}")
    check(n_clear > 0 and same == n_clear,
          f"[lm] xlstm-350m 17 layers: greedy tokens differ at {n_clear - same} clear positions")


def lm_full_width_stepwise(dev, card: str) -> None:
    """[lm] 2: h2o-danube-1.8b whole, fp32, on the card: 16 decode steps
    equal forward + lm_logits over the same tokens (rtol = atol = 2e-3)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key
    from repro_torch.launch.specs import model_decls
    from repro_torch.models import transformer as tfm
    from repro_torch.models.base import init_params, param_count
    from repro_torch.models.layers import lm_logits
    from repro_torch.train.serve_step import decode

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), dtype=torch.float32)
    t = time.perf_counter()
    model = init_params(model_decls(cfg), prng_key(SEED, dev))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == param_count(model_decls(cfg)), "full-width parameter count")
    toks = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(dev)
    with torch.no_grad():
        hidden, _ = tfm.forward(model, toks, cfg)
        full = lm_logits(model["embed"], hidden, cfg).float()
        cache = tfm.init_decode_cache(2, cfg, 16, dev)
        steps = []
        for i in range(16):
            lg, cache = decode(model, toks[:, i : i + 1], cache, i, cfg)
            steps.append(lg)
        steps = torch.stack(steps, 1)
    torch.cuda.synchronize()
    err = float((steps - full).abs().max())
    print(f"[lm] h2o-danube-1.8b full width fp32 on the card ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params:,} parameters, {n_params * 4 / 1e9:.2f} GB): 16 decode "
          f"steps == forward + lm_logits, max |dlogit| {err:.3g} (rtol=atol=2e-3; logits "
          f"up to {float(full.abs().max()):.3g}), {time.perf_counter() - t:.2f} s | {card}")
    check(bool(torch.isfinite(steps).all()), "[lm] full width: non-finite logits")
    check(torch.allclose(steps, full, rtol=2e-3, atol=2e-3),
          f"[lm] full width: stepwise decode differs from the forward by {err:.3g}")
    del model, hidden, full, cache, steps
    torch.cuda.empty_cache()


def lm_served(dev, card: str) -> dict:
    """[lm] 3: h2o-danube-1.8b whole, bf16, served through ``generate``
    (batch 4, prompt 32, 16 new tokens, greedy), twice the same tokens;
    times, peak memory and a profile of 8 decode steps.  Returns the
    times the roofline lines read."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import generate
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key
    from repro_torch.kernels import registry
    from repro_torch.launch.specs import model_decls
    from repro_torch.models import transformer as tfm
    from repro_torch.models.base import init_params
    from repro_torch.train.serve_step import decode, prefill, sample_tokens

    cfg = get_config("h2o-danube-1.8b")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(model_decls(cfg), prng_key(SEED, dev))
    b, plen, gen = 4, 32, 16
    prompts = torch.from_numpy(np.random.default_rng(SEED + 42).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)).to(dev)
    first = generate(cfg, model, prompts, gen)
    check(first.shape == (b, gen) and first.dtype == torch.int32, "[lm] generate: shape")
    check(bool(((first >= 0) & (first < cfg.vocab_size)).all()), "[lm] generate: vocab")
    torch.cuda.synchronize()
    t = time.perf_counter()
    second = generate(cfg, model, prompts, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(torch.equal(first, second), "[lm] generate: two runs gave different tokens")
    # Temperature sampling: categorical of the key chain, drawn by the
    # threefry kernel on the card; a seed repeats its tokens.
    before = registry.launch_counts()["threefry"]
    hot = [generate(cfg, model, prompts, gen, temperature=1.0, seed=SEED + s) for s in (0, 0, 1)]
    sampled_launches = registry.launch_counts()["threefry"] - before
    check(torch.equal(hot[0], hot[1]) and not torch.equal(hot[0], hot[2])
          and not torch.equal(hot[0], first) and sampled_launches >= 3 * 2 * gen,
          f"[lm] sampled generate: seeds do not repeat or the kernel did not draw "
          f"({sampled_launches} threefry launches)")
    check(bool(((hot[0] >= 0) & (hot[0] < cfg.vocab_size)).all()), "[lm] sampled: vocab")
    print(f"[lm] {cfg.name} bf16 generate at temperature 1.0: seed {SEED} twice the same "
          f"tokens, seed {SEED + 1} others; {sampled_launches} threefry launches for 3 runs "
          f"of {gen} tokens (split and categorical a token)")

    # Each decode step of a third run timed on both clocks: generate's loop
    # (the prompt teacher-forced, then greedy tokens) run here step by step.
    cache = tfm.init_decode_cache(b, cfg, plen + gen, dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    events, host, out = [torch.cuda.Event(enable_timing=True)], [], []
    torch.cuda.synchronize()
    host.append(time.perf_counter())
    events[0].record()
    tok = prompts[:, :1]
    for i in range(plen + gen):
        if i >= plen:
            tok, done = sample_tokens(None, logits, temperature=0.0, done=done)
            out.append(tok)
            tok = tok[:, None]
        logits, cache = decode(model, tok, cache, i, cfg)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        torch.cuda.synchronize()
        host.append(time.perf_counter())
        if i + 1 < plen:
            tok = prompts[:, i + 1 : i + 2]
    third = torch.stack(out, dim=1)
    del cache
    check(torch.equal(first, third), "[lm] the timed decode loop gave other tokens than generate")
    step_host = [(b2 - a) * 1e3 for a, b2 in zip(host, host[1:])]
    step_dev = [a.elapsed_time(b2) for a, b2 in zip(events, events[1:])]
    decode_ms, decode_dev_ms = statistics.median(step_host), statistics.median(step_dev)
    print(f"[lm] h2o-danube-1.8b bf16 generate (batch {b}, prompt {plen}, {gen} new, greedy): "
          f"two runs equal, tokens in the vocab; first row {first[0].tolist()} | {card}")
    print(f"[lm] decode step: median {decode_ms:.3f} ms on the host clock, "
          f"{decode_dev_ms:.3f} ms by CUDA events ({len(step_host)} steps; min "
          f"{min(step_host):.3f}, max {max(step_host):.3f}); generate wall {wall * 1e3:.1f} ms "
          f"for {plen + gen} decode steps: {b * gen / wall:.1f} new tokens/s, "
          f"{b * (plen + gen) / wall:.1f} decoded tokens/s | {card}")

    t2048 = torch.from_numpy(np.random.default_rng(SEED + 43).integers(
        0, cfg.vocab_size, (1, 2048)).astype(np.int32)).to(dev)
    pre = prefill(model, {"tokens": t2048}, cfg)
    check(bool(torch.isfinite(pre).all()), "[lm] prefill: non-finite logits")
    prefill_ms, held = time_ms(lambda: prefill(model, {"tokens": t2048}, cfg), inner=1,
                               repeats=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm] prefill batch 1 x 2,048 tokens (4 query chunks of 512): {prefill_ms:.3f} ms "
          f"by CUDA events{'' if held else ' (host gaps in)'}; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated, the served phase) | {card}")

    # Where a decode step's time goes: 8 steps (prompt 4, 4 new).
    generate(cfg, model, prompts[:, :4], 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        generate(cfg, model, prompts[:, :4], 4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = prof.key_averages()
    on_card = device_rows(rows)
    busy = sum(self_dev_us(e) for e in on_card)
    if busy:
        print(f"[profile] lm decode: 8 steps, wall {wall_us / 8:.1f} us/step, device busy "
              f"{busy / 8:.1f} us/step ({100 * busy / wall_us:.1f}% of wall), idle "
              f"{100 * (1 - busy / wall_us):.1f}%; {sum(e.count for e in on_card) / 8:.0f} "
              f"device operations a step | {card}")
        print_top_device("lm decode", on_card, 8, "step")
        for e in sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
            print(f"[profile] lm decode: host {e.self_cpu_time_total / 8:9.2f} us/step "
                  f"x{e.count // 8:<4d} {e.key[:80]}")
    else:
        print("[profile] lm decode: the profiler captured no device time (not measured)")
    del model
    torch.cuda.empty_cache()
    return {"cfg": cfg, "decode_ms": decode_ms, "decode_dev_ms": decode_dev_ms,
            "prefill_ms": prefill_ms}


def lm_roofline(served: dict, card: str) -> None:
    """[roofline] lm: the decode step's byte floor and prefill's compute
    floor beside the measured times."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.roofline import flops_estimate, hbm_bytes_estimate

    cfg = served["cfg"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_clock_mhz()
    peak = sms * mhz * 1e6 * BF16_FLOPS_PER_CLOCK_PER_SM
    print(f"[roofline] lm: dense bf16 peak {peak / 1e12:.1f} TFLOP/s = {sms} SMs x {mhz:g} MHz "
          f"(max SM clock) x {BF16_FLOPS_PER_CLOCK_PER_SM} FLOPs/clock/SM, against the data "
          f"sheet's 989 TFLOP/s at 1,830 MHz | {card}")
    nbytes = hbm_bytes_estimate(cfg, ShapeConfig("decode", 48, 4, "decode"), chips=1)
    floor = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[roofline] lm decode (batch 4, cache 48): byte floor {floor:.4f} ms "
          f"({nbytes:.4g} B over 3.35 TB/s, hbm_bytes_estimate) against {served['decode_ms']:.3f} "
          f"ms host / {served['decode_dev_ms']:.3f} ms events, achieved fraction "
          f"{floor / served['decode_ms']:.4f} | {card}")
    flops = flops_estimate(cfg, ShapeConfig("prefill", 2048, 1, "prefill"))
    floor = flops / peak * 1e3
    print(f"[roofline] lm prefill (batch 1 x 2,048): compute floor {floor:.3f} ms ({flops:.4g} "
          f"FLOPs, flops_estimate, over the bf16 peak) against {served['prefill_ms']:.3f} ms, "
          f"achieved fraction {floor / served['prefill_ms']:.4f} (the port's attention runs "
          f"in fp32) | {card}")


# ---------------------------------------------------------------------------
# 6. The LM substrate's training path ([lm train] lines)
# ---------------------------------------------------------------------------

#: Card against CPU, reduced archs, fp32: one step's loss (relative), its
#: gradient norm, and the losses of 3 steps; held on weights of each
#: layer's own fan-in, printed on the reference's draws.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_STEPS_RTOL = 1e-4
#: Remat on against remat off on the card (loss and gradient norm).
REMAT_RTOL = 1e-6
#: Full width: the training loss against the serving forward's cross
#: entropy, and the directional derivatives against central differences.
FULL_LOSS_RTOL = 1e-4
FD_RTOL = 1e-2
#: The central differences take the step along each unit direction ``u``
#: that moves the loss by this much to first order: eps = FD_DELTA / <g, u>.
#: The check is made at FD_DELTA; the other steps are printed beside it.
FD_DELTA = 1e-2
FD_DELTAS = (1e-1, 1e-2, 1e-3, 1e-4)
#: The float64 witness on the reference's draws: its central differences
#: against the float64 and the float32 gradient at FD64_DELTA (FD_RTOL),
#: the other steps printed.
FD64_DELTA = 1e-5
FD64_DELTAS = (1e-2, 1e-3, 1e-4, 1e-5, 1e-6)
#: The bf16 training run of h2o-danube-1.8b.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES, TRAIN_RUN_STEPS = 4, 2048, 2, 8


def _train_cfgs(dtype):
    """``(arch, cfg, decls, fan_in)``: every arch reduced in ``dtype``, on
    weights of each layer's own fan-in (xLSTM at its 17 layers), then on
    the reference's draws (xLSTM on the 3-layer stack, as in the [lm]
    phase)."""
    import dataclasses

    from repro_torch.configs import get_config, paired_archs, reduced_config
    from repro_torch.launch.specs import model_decls

    for fan_in in (True, False):
        for arch in paired_archs():
            extra = XLSTM_SHALLOW if arch == "xlstm-350m" and not fan_in else {}
            cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype, **extra)
            yield arch, cfg, model_decls(cfg, fan_in=fan_in), fan_in


def _train_run(cfg, tcfg, model, dev, steps: int):
    """``steps`` train steps of a copy of ``model`` on ``dev`` over the
    synthetic batches (batch 4, seq 32); returns the metrics per step as
    floats and the state."""
    import copy

    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.train.train_step import init_train_state, make_train_step

    state = init_train_state(copy.deepcopy(model).to(dev), tcfg)
    step_fn = make_train_step(cfg, tcfg)
    out = []
    for step in range(steps):
        batch = {k: v.to(dev) for k, v in synthetic_lm_batch(cfg, 4, 32, step, "cpu").items()}
        state, m = step_fn(state, batch)
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def _train_errors(runs, ref) -> tuple[float, float, float]:
    """The largest relative deviation of ``runs`` (lists of per-step
    metrics) from ``ref``: the first step's loss and gradient norm, and
    the losses over all steps."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    return (max(rel(r[0]["loss"], ref[0]["loss"]) for r in runs),
            max(rel(r[0]["grad_norm"], ref[0]["grad_norm"]) for r in runs),
            max(rel(a["loss"], b["loss"]) for r in runs for a, b in zip(r, ref)))


def lm_train_card_against_cpu(dev, card: str) -> None:
    """[lm train] 1: every arch reduced, fp32, microbatches 2, remat on:
    the card against the CPU from the same weights and batches (one step,
    then three), and remat on against remat off on the card (1e-6).  The
    card == CPU tolerances hold on weights of each layer's own fan-in; on
    the reference's draws, whose init leaves some reduced archs' float32
    gradients ill-conditioned (tests/test_torch_lm_train.py), the same
    errors are printed beside them, not held."""
    import dataclasses

    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.core.prng import prng_key
    from repro_torch.models.base import init_params

    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6, microbatches=2,
                       remat="full")
    tol = (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_STEPS_RTOL)
    for arch, cfg, decls, fan_in in _train_cfgs(torch.float32):
        model = init_params(decls, prng_key(SEED))
        cpu, _ = _train_run(cfg, tcfg, model, "cpu", 3)
        on_card, state = _train_run(cfg, tcfg, model, dev, 3)
        check(all(p.device == dev for p in state["params"].parameters()),
              f"[lm train] {arch}: the state is not on {dev}")
        off, _ = _train_run(cfg, dataclasses.replace(tcfg, remat="none"), model, dev, 1)
        e_loss, e_gn, e_steps = _train_errors([on_card], cpu)
        r_loss, r_gn, _ = _train_errors([on_card[:1]], off)
        weights = ("weights of each layer's own fan-in" if fan_in
                   else "the reference's draws, printed only")
        held = "tolerance " if fan_in else "not held; "
        print(f"[lm train] {arch} reduced ({cfg.n_layers} layers, {weights}) card == CPU: loss "
              f"{on_card[0]['loss']:.6f} (rel {e_loss:.2e}; {held}{tol[0]:.0e}), grad_norm "
              f"{on_card[0]['grad_norm']:.6f} (rel {e_gn:.2e}; {held}{tol[1]:.0e}), 3 steps' "
              f"losses rel {e_steps:.2e} ({held}{tol[2]:.0e}); remat on == off on the card: "
              f"loss rel {r_loss:.2e}, grad_norm rel {r_gn:.2e} | {card}")
        what = f"[lm train] {arch} ({weights})"
        check(all(torch.isfinite(torch.tensor(m["loss"])) for m in on_card),
              f"{what}: non-finite loss")
        if fan_in:
            check(e_loss <= tol[0], f"{what}: loss rel {e_loss:.3g}")
            check(e_gn <= tol[1], f"{what}: grad_norm rel {e_gn:.3g}")
            check(e_steps <= tol[2], f"{what}: 3 steps' losses rel {e_steps:.3g}")
        check(r_loss <= REMAT_RTOL and r_gn <= REMAT_RTOL,
              f"{what}: remat on and off differ ({r_loss:.3g}, {r_gn:.3g})")


def _grads(model, toks, cfg):
    """The loss (a float) and its gradient by parameter name, remat on."""
    import torch

    from repro_torch.models import transformer as tfm

    model.requires_grad_(True)
    names, leaves = zip(*model.named_parameters())
    loss = tfm.lm_loss(model, toks, cfg, remat=True)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    model.requires_grad_(False)
    return float(loss.detach()), grads


def _directions(cfg) -> dict:
    """The supports of the four unit directions: all parameters (g/|g|),
    the embedding, layer 0's query weight, the last layer's MLP down
    projection."""
    last = cfg.n_layers - 1
    return {"g/|g|": None, "embed.tok": ["embed.tok"], "layers.0.attn.wq": ["layers.0.attn.wq"],
            f"layers.{last}.mlp.w_down": [f"layers.{last}.mlp.w_down"]}


def _central_differences(model, toks, cfg, grads, support, deltas, against) -> tuple:
    """Central differences of ``model``'s loss along u = ``grads`` / |grads|
    on ``support``.  For each first-order change ``delta`` of ``deltas``
    the step is eps = delta / |grads|; the parameters are set to
    theta +- eps u as their dtype stores them, and the difference of the
    two losses is held against <g, theta+ - theta-> over the stored steps
    for each gradient g of ``against`` (so the rounding of a step of a few
    ulps does not count as an error).  Returns (|grads| on ``support``,
    which is <grads, u>, and {name of ``against``: {delta: relative
    error}})."""
    import torch

    from repro_torch.models import transformer as tfm

    params = dict(model.named_parameters())
    norm = float(torch.sqrt(sum(torch.sum(grads[n].double() ** 2) for n in support)))
    errs = {k: {} for k in against}
    with torch.no_grad():
        saved = {n: params[n].detach().clone() for n in support}
        for delta in deltas:
            eps = delta / norm
            losses, dots = [], dict.fromkeys(against, 0.0)
            for sign in (1.0, -1.0):
                for n in support:
                    params[n].copy_(saved[n] + (sign * eps / norm) * grads[n])
                    step = params[n].double() - saved[n].double()
                    for k, g in against.items():
                        dots[k] += sign * float(torch.sum(g[n].double() * step))
                losses.append(float(tfm.lm_loss(model, toks, cfg)))
            for n in support:
                params[n].copy_(saved[n])
            for k in against:
                errs[k][delta] = abs((losses[0] - losses[1]) - dots[k]) / abs(dots[k])
        del saved
    return norm, errs


def _ladder(errs: dict) -> str:
    return "{" + ", ".join(f"{d:g}: {e:.2e}" for d, e in errs.items()) + "}"


def lm_train_full_width_fp32(dev, card: str) -> None:
    """[lm train] 2: h2o-danube-1.8b whole, fp32, 1 x 512 tokens, remat on:
    the training loss equals the serving forward's cross entropy, and the
    gradient's directional derivatives equal central differences of the
    loss (:func:`_central_differences`), held on weights of each layer's
    own fan-in and printed on the reference's draws, whose float32 loss
    does not resolve a central difference at this width (PERF.md).  There
    the float64 witness (:func:`_fd64_witness`) follows."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key
    from repro_torch.launch.specs import model_decls
    from repro_torch.models import transformer as tfm
    from repro_torch.models.base import init_params
    from repro_torch.models.layers import lm_logits

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(SEED + 51).integers(
        0, cfg.vocab_size, (1, 512)).astype(np.int32)).to(dev)
    for weights, fan_in in (("the reference's draws", False),
                            ("weights of each layer's own fan-in", True)):
        t = time.perf_counter()
        model = init_params(model_decls(cfg, fan_in=fan_in),
                            prng_key(SEED, dev))
        with torch.no_grad():
            hidden, _ = tfm.forward(model, toks, cfg)
            logits = lm_logits(model["embed"], hidden[:, :-1], cfg).float()
            served = float(torch.nn.functional.cross_entropy(logits[0], toks[0, 1:].long()))
            del hidden, logits
        loss, grads = _grads(model, toks, cfg)
        e_loss = abs(loss - served) / abs(served)
        print(f"[lm train] h2o-danube-1.8b full width fp32 (1 x 512, remat on, {weights}): "
              f"lm_loss {loss:.6f} == the served forward's cross entropy {served:.6f} (rel "
              f"{e_loss:.2e}, tolerance {FULL_LOSS_RTOL:g}) | {card}")
        check(np.isfinite(loss) and e_loss <= FULL_LOSS_RTOL,
              f"[lm train] full width: lm_loss {loss} against the served cross entropy {served}")
        for label, support in _directions(cfg).items():
            norm, errs = _central_differences(model, toks, cfg, grads, support or list(grads),
                                              FD_DELTAS, {"g": grads})
            errs = errs["g"]
            verdict = (f"at {FD_DELTA:g}: rel {errs[FD_DELTA]:.2e} (tolerance {FD_RTOL:g})"
                       if fan_in else "not held")
            print(f"[lm train] full width ({weights}) directional derivative along {label}: "
                  f"<g, u> {norm:.6g}; central differences {verdict}; rel by first-order "
                  f"change {_ladder(errs)} | {card}")
            if fan_in:
                check(errs[FD_DELTA] <= FD_RTOL, f"[lm train] full width: directional "
                      f"derivative along {label} off by {errs[FD_DELTA]:.3g}")
        print(f"[lm train] full width fp32 checks on {weights}: {time.perf_counter() - t:.2f} s")
        del model
        torch.cuda.empty_cache()
        if not fan_in:
            _fd64_witness(grads, loss, toks, cfg, dev, card)
        del grads
        torch.cuda.empty_cache()


def _fd64_witness(g32: dict, loss32: float, toks, cfg, dev, card: str) -> None:
    """[lm train] 2b: on the reference's draws, the same model in float64
    (the float32 draws widened exactly, 14.6 GB): its loss against the
    float32 loss, its gradient against the float32 one, and central
    differences of the float64 loss along the float32 gradient's four
    directions, held against the float64 and the float32 gradient at
    ``FD64_DELTA`` and printed against both at each step of
    ``FD64_DELTAS``: the full-width check of the float32 backward on the
    weights the port trains."""
    import dataclasses

    import torch

    from repro_torch.core.prng import prng_key
    from repro_torch.launch.specs import model_decls
    from repro_torch.models.base import init_params

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    model = init_params(model_decls(cfg64), prng_key(SEED, dev))
    loss64, g64 = _grads(model, toks, cfg64)
    e_loss = abs(loss32 - loss64) / abs(loss64)
    print(f"[lm train] full width float64 witness (the reference's draws, widened): lm_loss "
          f"{loss64:.12f}, the float32 loss {loss32:.6f} (rel {e_loss:.2e}, tolerance "
          f"{FULL_LOSS_RTOL:g}) | {card}")
    check(e_loss <= FULL_LOSS_RTOL, f"[lm train] float64 witness: loss {loss64} against {loss32}")
    for label, support in _directions(cfg).items():
        support = support or list(g32)
        dist = float(torch.sqrt(sum(torch.sum((g32[n].double() - g64[n].double()) ** 2)
                                    for n in support))
                     / torch.sqrt(sum(torch.sum(g64[n].double() ** 2) for n in support)))
        norm, errs = _central_differences(model, toks, cfg64, g32, support, FD64_DELTAS,
                                          {"fp64": g64, "fp32": g32})
        e64, e32 = errs["fp64"][FD64_DELTA], errs["fp32"][FD64_DELTA]
        print(f"[lm train] full width float64 witness along {label}: <g32, u> {norm:.6g}, "
              f"|g32 - g64| / |g64| {dist:.2e}; float64 central differences at {FD64_DELTA:g} "
              f"against the float64 gradient rel {e64:.2e}, against the float32 gradient rel "
              f"{e32:.2e} (tolerance {FD_RTOL:g}); by first-order change against the float64 "
              f"gradient {_ladder(errs['fp64'])}, against the float32 gradient "
              f"{_ladder(errs['fp32'])} | {card}")
        for name, e in (("float64", e64), ("float32", e32)):
            check(e <= FD_RTOL, f"[lm train] float64 witness: the {name} gradient along "
                  f"{label} off by {e:.3g}")
    print(f"[lm train] full width float64 witness: {time.perf_counter() - t:.2f} s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    del model, g64
    torch.cuda.empty_cache()


def _lm_train_steps(cfg, tcfg, model, batches, label: str, card: str):
    """``TRAIN_RUN_STEPS`` train steps of ``model`` over ``batches``, each
    step's metrics and times printed; returns (state, losses, host ms,
    CUDA-event ms)."""
    import torch

    from repro_torch.train.train_step import init_train_state, make_train_step

    state = init_train_state(model, tcfg)
    step_fn = make_train_step(cfg, tcfg)
    losses, host_ms, dev_ms = [], [], []
    for step in range(TRAIN_RUN_STEPS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        state, m = step_fn(state, batches[step])
        stop.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(start.elapsed_time(stop))
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        print(f"[lm train] h2o-danube-1.8b bf16 ({label}) step {step}: loss {m['loss']:.4f} "
              f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.3e}; {host_ms[-1]:.1f} ms host "
              f"clock, {dev_ms[-1]:.1f} ms CUDA events | {card}")
    return state, step_fn, losses, host_ms, dev_ms


def lm_train_run(dev, card: str) -> dict:
    """[lm train] 3: h2o-danube-1.8b whole, bf16 weights with fp32 masters,
    trained 8 steps at 4 x 2,048 (microbatches 2, remat full) on the
    synthetic stream; each step's metrics and times, tokens/s, peak memory,
    and a profile of one more step.  Returns the median step time.

    The timed run draws the weights with each layer's own fan-in, where a
    falling loss shows the step trains.  The same 8 steps on the
    reference's own draws (the stacked layers' std ``1/sqrt(24)``,
    ill-conditioned at full width, see the central differences above) run
    beside it, printed: there 8 steps move the loss by a few hundredths
    either way, so their loss is not held to fall."""
    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.prng import prng_key
    from repro_torch.launch.specs import model_decls
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models.base import init_params

    cfg = get_config("h2o-danube-1.8b")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=TRAIN_RUN_STEPS,
                       microbatches=TRAIN_MICROBATCHES, remat="full")
    batches = [synthetic_lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, s, dev)
               for s in range(TRAIN_RUN_STEPS + 1)]
    tokens = TRAIN_BATCH * TRAIN_SEQ

    model = init_params(model_decls(cfg), prng_key(SEED, dev))
    state, _, ref_losses, _, _ = _lm_train_steps(cfg, tcfg, model, batches,
                                                 "the reference's draws", card)
    del state, model
    torch.cuda.empty_cache()
    print(f"[lm train] h2o-danube-1.8b bf16 on the reference's draws, {TRAIN_RUN_STEPS} "
          f"steps: loss {ref_losses[0]:.4f} -> {ref_losses[-1]:.4f} (mean of the last three "
          f"{float(np.mean(ref_losses[-3:])):.4f}; printed, not held) | {card}")
    check(all(np.isfinite(ref_losses)), f"[lm train] non-finite loss: {ref_losses}")

    torch.cuda.reset_peak_memory_stats()
    model = init_params(model_decls(cfg, fan_in=True), prng_key(SEED, dev))
    state, step_fn, losses, host_ms, dev_ms = _lm_train_steps(cfg, tcfg, model, batches,
                                                              "fan-in weights", card)
    peak = torch.cuda.max_memory_allocated()
    steady = host_ms[1:]
    step_ms = statistics.median(steady)
    print(f"[lm train] h2o-danube-1.8b bf16 (fp32 masters) at {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"microbatches {TRAIN_MICROBATCHES}, remat full, {TRAIN_RUN_STEPS} steps: median step "
          f"{step_ms:.1f} ms host ({statistics.median(dev_ms[1:]):.1f} ms events; first step "
          f"{host_ms[0]:.1f} ms), {tokens / step_ms * 1e3:,.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated) | {card}")
    check(all(np.isfinite(losses)), f"[lm train] non-finite loss: {losses}")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"[lm train] the loss did not fall: first {losses[0]}, last three {losses[-3:]}")

    # Where a step's time goes: one more step under the profiler.
    state = _profile_step("lm train step", step_fn, state, batches[TRAIN_RUN_STEPS], card)
    del state, model, batches
    torch.cuda.empty_cache()
    return {"cfg": cfg, "step_ms": step_ms}


def lm_train_roofline(run: dict, card: str) -> None:
    """[roofline] lm train: the step's compute floor (``flops_estimate``
    over the dense bf16 peak) beside the measured step."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.roofline import flops_estimate

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * max_sm_clock_mhz() * 1e6 * BF16_FLOPS_PER_CLOCK_PER_SM
    flops = flops_estimate(run["cfg"], ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    floor = flops / peak * 1e3
    print(f"[roofline] lm train (batch {TRAIN_BATCH} x {TRAIN_SEQ}): compute floor {floor:.1f} "
          f"ms ({flops:.4g} FLOPs, flops_estimate, 3x the forward, no remat recompute, over "
          f"{peak / 1e12:.1f} TFLOP/s dense bf16) against {run['step_ms']:.1f} ms, achieved "
          f"fraction {floor / run['step_ms']:.4f} | {card}")


def lm_train_resume(dev, card: str) -> None:
    """[lm train] 4: reduced h2o-danube, fp32, on the card through
    ``run_training``: 4 steps straight against 2 steps, a checkpoint and a
    resumed run to 4; the last losses and the final states agree."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import TrainConfig, get_config, reduced_config
    from repro_torch.launch.train import run_training

    cfg = dataclasses.replace(reduced_config(get_config("h2o-danube-1.8b")), dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4, checkpoint_every=2)
    kw = dict(device=dev, batch=4, seq=32, log_every=4)
    with tempfile.TemporaryDirectory() as d:
        whole = run_training(cfg, tcfg, steps=4, ckpt_dir=f"{d}/a", **kw)
        again = run_training(cfg, tcfg, steps=4, ckpt_dir=f"{d}/c", **kw)
        run_training(cfg, tcfg, steps=2, ckpt_dir=f"{d}/b", **kw)
        resumed = run_training(cfg, tcfg, steps=4, ckpt_dir=f"{d}/b", **kw)
    err = abs(resumed["loss"] - whole["loss"]) / abs(whole["loss"])
    repeat = "bit for bit" if again == whole else (
        f"not bit for bit (loss {again['loss']!r} against {whole['loss']!r}: the card's "
        f"backward is not deterministic)")
    print(f"[lm train] resume on the card (reduced h2o-danube fp32, 4 steps, checkpoint at 2): "
          f"last loss {resumed['loss']:.7f} against {whole['loss']:.7f} uninterrupted (rel "
          f"{err:.2e}, tolerance 1e-5); an uninterrupted run repeated: {repeat} | {card}")
    check(err <= 1e-5, f"[lm train] resumed run's loss {resumed['loss']} != {whole['loss']}")


# ---------------------------------------------------------------------------
# 7. The LM substrate over a mesh ([lm mesh] lines)
# ---------------------------------------------------------------------------

#: The meshed train step against the unmeshed one: losses and grad_norm
#: (relative) on the reduced archs in fp32, and on h2o-danube-1.8b whole in
#: bf16 (at least these; printed as measured).
MESH_LOSS_RTOL, MESH_GNORM_RTOL = 1e-6, 1e-5
MESH_FULL_LOSS_RTOL, MESH_FULL_GNORM_RTOL = 1e-3, 1e-2
#: Under a profile that splits over ``model`` the layers sum partial
#: products in another float order than the unmeshed products.  Where
#: rounding grows past a bound above (xLSTM's 17 layers, the compressed
#: residual, h2o-danube-1.8b on the reference's draws, whose gradient is
#: decided by rounding), the split is held instead within WITNESS_K times
#: the largest shift of the unmeshed run itself over WITNESS_DRAWS draws of
#: its weights each moved one ulp, up or down at random (``_nudged``; the
#: CPU tests hold the same, ``tests/test_torch_lm_mesh.py``).
WITNESS_DRAWS, WITNESS_K = 3, 2.0
#: The (data, model) grids of the phase, every position the card: the
#: train mesh under the "tp" profile, the decode mesh under "serve_tp".
MESH_TRAIN, MESH_SERVE = (2, 2), (1, 2)
#: h2o-danube-1.8b's train state in GB (bf16 parameters; fp32 m, v, master).
H2O_STATE_GB = 25.64


@contextlib.contextmanager
def _sharding_profile(name: str):
    """The port's sharding profile set to ``name`` for a ``with`` block."""
    from repro_torch.sharding import partition

    before = partition.get_profile()
    partition.set_profile(name)
    try:
        yield
    finally:
        partition.set_profile(before)


def _mesh_steps(state, step_fn, batches) -> list:
    """Each step's metrics as floats, with its host-clock and CUDA-event ms."""
    import torch

    out = []
    for b in batches:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        state, m = step_fn(state, b)
        stop.record()
        torch.cuda.synchronize()
        m = {k: float(v) for k, v in m.items()}
        m["host_ms"], m["dev_ms"] = (time.perf_counter() - t) * 1e3, start.elapsed_time(stop)
        out.append(m)
    return out


def _rel_errs(a: list, b: list, key: str) -> float:
    return max(abs(x[key] - y[key]) / abs(y[key]) for x, y in zip(a, b))


def _nudged(model, seed: int):
    """``model`` with every floating leaf moved one ulp, up or down at random
    (from ``seed``), in place; returns it."""
    import torch

    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            up = torch.randint(0, 2, p.shape, generator=gen, device=p.device).bool()
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf).to(p.dtype)))
    return model


def _held(label: str, errs: dict, tols: dict, draw) -> str:
    """Each of ``errs`` (name -> the meshed run's relative error against the
    unmeshed run) within its bound in ``tols``, or, past it, within
    WITNESS_K times the largest error of WITNESS_DRAWS unmeshed runs on
    ``_nudged`` weights (``draw(seed)`` gives their errors, keyed alike;
    drawn only when a bound is passed).  Returns the readings."""
    past = [k for k, e in errs.items() if e > tols[k]]
    if not past:
        return "within the bounds"
    draws = [draw(seed) for seed in range(WITNESS_DRAWS)]
    out = []
    for k in past:
        wit = max(d[k] for d in draws)
        out.append(f"{k} {errs[k]:.2e} past {tols[k]:.0e}, the unmeshed run's own one-ulp "
                   f"shifts {[f'{d[k]:.2e}' for d in draws]}")
        check(errs[k] <= WITNESS_K * wit,
              f"{label}: {k} rel {errs[k]:.3g} past {tols[k]:.0e} and past {WITNESS_K} x "
              f"the one-ulp witness {wit:.3g}")
    return "; ".join(out) + f" (held at {WITNESS_K:g} x the largest)"


def _gathered_line(arch: str, store) -> str:
    """The leaves a step gathered across ``model``, with their reasons."""
    if not store.gathered:
        return f"[lm mesh] {arch}: 0 leaves gathered across model"
    by_reason: dict = {}
    for name, reason in store.gathered.items():
        by_reason.setdefault(reason, []).append(name)
    return (f"[lm mesh] {arch}: {len(store.gathered)} leaves gathered across model: "
            + "; ".join(f"{', '.join(names)} ({reason})" for reason, names in by_reason.items()))


def lm_mesh_reduced(dev, card: str) -> None:
    """[lm mesh] 1: every arch reduced, fp32, on weights of each layer's own
    fan-in: 3 train steps at 4 x 32 on a (2, 2) mesh of the card at
    microbatches 1 against the unmeshed step on the card at the matching
    count (2, which adds the same per-shard sums; 1 for the MoE archs,
    whose routing groups and balance loss are those of the whole
    microbatch).  Under "tp", where the layers split over ``model``: every
    arch, and again compressed for h2o-danube and qwen2-moe, held at the
    bounds or, past them, at the one-ulp witness (``_held``: xLSTM's 17
    layers grow the split's float order past them, as they grow any
    rounding; a gradient that it moves across an int8 rounding boundary
    moves the compressed residual by a quantum); beside them at the bounds
    alone xLSTM on its 3-layer stack, the compressed pair in float64, and
    phi3.5-moe at 16 experts (sharded over ``model``); each with the leaves
    it gathered across ``model`` and a check that every position read its
    own blocks.  Under
    "dp", where nothing splits, every arch whole, bit for bit but for the
    MoE archs (the whole microbatch's routing, summed in float32).  Then a
    "serve_tp" (1, 2) decode of reduced recurrentgemma on a cache laid out
    by ``cache_shardings``, 8 steps, logits within 1e-5."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import TrainConfig, get_config, paired_archs, reduced_config
    from repro_torch.core.prng import prng_key
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import model_decls
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.base import init_params
    from repro_torch.sharding.blocks import shard_params
    from repro_torch.train.serve_step import decode
    from repro_torch.train.train_step import init_train_state, make_train_step

    mesh = make_test_mesh(*MESH_TRAIN, device=dev)
    f32, f64 = torch.float32, torch.float64
    # (profile, arch, compressed, config changes, dtype, held at the bounds alone)
    cases = ([("tp", a, False, {}, f32, False) for a in paired_archs()]
             + [("tp", "h2o-danube-1.8b", True, {}, f32, False),
                ("tp", "qwen2-moe-a2.7b", True, {}, f32, False),
                ("tp", "xlstm-350m", False, XLSTM_SHALLOW, f32, True),
                ("tp", "h2o-danube-1.8b", True, {}, f64, True),
                ("tp", "qwen2-moe-a2.7b", True, {}, f64, True),
                ("tp", "phi3.5-moe-42b-a6.6b", False, {"n_experts": 16}, f32, True)]
             + [("dp", a, False, {}, f32, True) for a in paired_archs()])
    for prof, arch, comp, changes, dtype, strict in cases:
        with _sharding_profile(prof):
            cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype, **changes)
            model = init_params(model_decls(cfg, fan_in=True),
                                prng_key(SEED)).to(dev)
            tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6,
                               remat="full", grad_compression=comp)
            k_flat = 1 if cfg.is_moe else MESH_TRAIN[0]
            flat_cfg = dataclasses.replace(tcfg, microbatches=k_flat)
            batches = [synthetic_lm_batch(cfg, 4, 32, s, dev) for s in range(3)]
            flat = _mesh_steps(init_train_state(copy.deepcopy(model), flat_cfg),
                               make_train_step(cfg, flat_cfg), batches)
            state = init_train_state(shard_params(model, cfg, mesh), tcfg)
            store = state["params"]
            check(all(b.device == dev for bl in store.blocks.values() for b in bl.values()),
                  f"[lm mesh] {arch}: a block is not on {dev}")
            meshed = _mesh_steps(state, make_train_step(cfg, tcfg, mesh), batches)
        tols = {"loss": MESH_LOSS_RTOL, "grad_norm": MESH_GNORM_RTOL,
                "residual_norm": MESH_GNORM_RTOL}
        errs = {k: _rel_errs(meshed, flat, k) for k in tols if k in flat[0]}
        e_loss, e_gn = errs["loss"], errs["grad_norm"]
        same = all(a[k] == b[k] for a, b in zip(meshed, flat) for k in ("loss", "grad_norm"))
        extra = f", residual_norm rel {errs['residual_norm']:.2e}" if comp else ""
        label = (f"{arch} reduced {'fp32' if dtype == f32 else 'float64'}"
                 f"{' compressed' if comp else ''}"
                 f"{''.join(f' {k}={v}' for k, v in changes.items() if k == 'n_experts')}"
                 f"{' (3-layer stack)' if changes is XLSTM_SHALLOW else ''}")
        print(f"[lm mesh] {label}: (2, 2) {prof} mesh "
              f"of the card at microbatches 1 == unmeshed at {k_flat}, 3 steps: losses "
              f"{[round(m['loss'], 6) for m in meshed]}, rel {e_loss:.2e} (tolerance "
              f"{MESH_LOSS_RTOL:.0e}), grad_norm rel {e_gn:.2e} ({MESH_GNORM_RTOL:.0e})"
              f"{extra}; {'bit for bit' if same else 'not bit for bit'}; meshed step "
              f"{statistics.median(m['host_ms'] for m in meshed[1:]):.1f} ms against "
              f"{statistics.median(m['host_ms'] for m in flat[1:]):.1f} ms (host clock) "
              f"| {card}")
        check(all(torch.isfinite(torch.tensor(m["loss"])) for m in meshed),
              f"[lm mesh] {arch}: non-finite loss")
        if strict:
            for k, e in errs.items():
                check(e <= tols[k], f"[lm mesh] {label}: {k} rel {e:.3g}")
        else:
            def draw(seed):
                runs = _mesh_steps(init_train_state(_nudged(copy.deepcopy(model), seed),
                                                    flat_cfg),
                                   make_train_step(cfg, flat_cfg), batches)
                return {k: _rel_errs(runs, flat, k) for k in errs}

            print(f"[lm mesh] {label} under tp: {_held(f'[lm mesh] {label}', errs, tols, draw)} "
                  f"| {card}")
        if prof == "dp":      # nothing splits; without MoE the unmeshed sums, bit for bit
            check(not store.local_reads and not store.gathered,
                  f"[lm mesh] {arch}: under dp a layer split over model")
            check(same or cfg.is_moe,
                  f"[lm mesh] {arch}: under dp the meshed step is not the unmeshed one bit "
                  f"for bit")
            continue
        print(_gathered_line(label, store) + f"; positions that read their own blocks "
              f"{sorted(store.local_reads)} | {card}")
        check(set(store.local_reads) == set(store.positions),
              f"[lm mesh] {arch}: positions without work {set(store.positions) - set(store.local_reads)}")
        if arch == "h2o-danube-1.8b" or changes.get("n_experts") == 16:
            check(not store.gathered, f"[lm mesh] {arch}: gathered {store.gathered}")

    with _sharding_profile("serve_tp"):
        cfg = dataclasses.replace(reduced_config(get_config("recurrentgemma-2b")),
                                  dtype=torch.float32)
        model = init_params(model_decls(cfg), prng_key(SEED)).to(dev)
        smesh = make_test_mesh(*MESH_SERVE, device=dev)
        store = shard_params(model, cfg, smesh)
        c0 = tfm.init_decode_cache(4, cfg, 8, dev)
        c1 = tfm.init_decode_cache(4, cfg, 8, dev, mesh=smesh)
        tok = torch.arange(4, dtype=torch.int32, device=dev)[:, None]
        worst, equal = 0.0, True
        with torch.no_grad():
            for i in range(8):
                l0, c0 = decode(model, tok, c0, i, cfg)
                l1, c1 = decode(store, tok, c1, i, cfg, mesh=smesh)
                worst = max(worst, float((l1 - l0).abs().max()))
                equal = equal and torch.equal(l1, l0)
                tok = l0.argmax(-1).to(torch.int32)[:, None]
        print(f"[lm mesh] recurrentgemma-2b reduced fp32: serve_tp (1, 2) decode, 8 steps, the "
              f"cache laid out by cache_shardings (k/v {c1.specs['2.k']}, h {c1.specs['0.h']}): "
              f"max |dlogit| {worst:.3g} against the unmeshed decode ({'equal' if equal else 'not'} "
              f"bit for bit) | {card}")
        print(_gathered_line("recurrentgemma-2b serve_tp decode", store) + f" | {card}")
        check(worst <= 1e-5, f"[lm mesh] serve_tp decode: logits differ by {worst:.3g}")
        check(set(store.local_reads) == set(store.positions),
              "[lm mesh] serve_tp decode: a position read none of its blocks")


def _full_width_flat(cfg, dev, batches, fan_in: bool, nudge=None) -> list:
    """3 unmeshed steps of h2o-danube-1.8b whole (``cfg``'s dtype, fp32
    masters, remat full, microbatches 2) from fresh weights (with
    ``nudge``, ``_nudged`` by that seed); each step's metrics."""
    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.core.prng import prng_key
    from repro_torch.launch.specs import model_decls
    from repro_torch.models.base import init_params
    from repro_torch.train.train_step import init_train_state, make_train_step

    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=TRAIN_RUN_STEPS,
                       microbatches=MESH_TRAIN[0], remat="full")
    model = init_params(model_decls(cfg, fan_in=fan_in),
                        prng_key(SEED, dev))
    if nudge is not None:
        _nudged(model, nudge)
    out = _mesh_steps(init_train_state(model, tcfg), make_train_step(cfg, tcfg), batches)
    del model
    torch.cuda.empty_cache()
    return out


def _full_width_steps(cfg, dev, card: str, profile: bool, fan_in: bool = False) -> dict:
    """3 unmeshed steps of h2o-danube-1.8b whole (``_full_width_flat``, on
    the reference's draws or with ``fan_in`` on weights of each layer's own
    fan-in), freed, then 3 steps on a (2, 2) "tp" mesh of the card at
    microbatches 1 from the same initial state (with ``profile``, and one
    more meshed step under the profiler).  Returns both runs' metrics, the
    batches, peak memory, the state's bytes a position, the dry-run's
    argument bytes, and the store's record of gathered leaves and
    own-block reads."""
    import torch

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.core.prng import prng_key
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import model_decls
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models.base import init_params
    from repro_torch.sharding.blocks import shard_params
    from repro_torch.train.train_step import init_train_state, make_train_step

    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=TRAIN_RUN_STEPS,
                       microbatches=1, remat="full")
    batches = [synthetic_lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, s, dev) for s in range(4)]
    out: dict = {"batches": batches[:3]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["flat"] = _full_width_flat(cfg, dev, batches[:3], fan_in)
    out["flat_peak"] = torch.cuda.max_memory_allocated()
    with _sharding_profile("tp"):
        mesh = make_test_mesh(*MESH_TRAIN, device=dev)
        torch.cuda.reset_peak_memory_stats()
        model = init_params(model_decls(cfg, fan_in=fan_in),
                            prng_key(SEED, dev))
        store = shard_params(model, cfg, mesh)
        del model
        state = init_train_state(store, tcfg)
        out["per_pos"] = [sum(st.nbytes_at(pos) for st in (state["params"], state["opt"].m,
                                                            state["opt"].v, state["opt"].master))
                          + 4 for pos in store.positions]
        out["args"], _ = dryrun.cell_bytes(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                                            "train"),
                                           make_test_mesh(*MESH_TRAIN, device="meta"), 1)
        step_fn = make_train_step(cfg, tcfg, mesh)
        out["meshed"] = _mesh_steps(state, step_fn, batches[:3])
        out["mesh_peak"] = torch.cuda.max_memory_allocated()
        out["reads"], out["positions"] = dict(store.local_reads), list(store.positions)
        out["gathered"] = dict(store.gathered)
        out["gathered_line"] = _gathered_line("h2o-danube-1.8b (2, 2) tp", store)
        if profile:
            state = _profile_step("lm mesh step (2, 2) tp", step_fn, state, batches[3], card)
    del state, store
    torch.cuda.empty_cache()
    return out


def _full_width_held(name: str, cfg, run: dict, dev, fan_in: bool) -> str:
    """The meshed run of ``_full_width_steps`` against the unmeshed one over
    its 3 steps: loss and grad_norm (largest relative differences) at the
    MESH_FULL bounds or, past them, at the one-ulp witness of ``_held``.
    Returns the readings."""
    errs = {k: _rel_errs(run["meshed"], run["flat"], k) for k in ("loss", "grad_norm")}
    tols = {"loss": MESH_FULL_LOSS_RTOL, "grad_norm": MESH_FULL_GNORM_RTOL}
    label = f"[lm mesh] h2o-danube-1.8b {name}"

    def draw(seed):
        again = _full_width_flat(cfg, dev, run["batches"], fan_in, nudge=seed)
        return {k: _rel_errs(again, run["flat"], k) for k in errs}

    held = _held(label, errs, tols, draw)
    first = {k: _rel_errs(run["meshed"][:1], run["flat"][:1], k) for k in errs}
    check(all(math.isfinite(m["loss"]) for m in run["meshed"]), f"{label}: non-finite loss")
    return (f"loss rel {errs['loss']:.2e} (step 0 {first['loss']:.2e}; bound "
            f"{MESH_FULL_LOSS_RTOL:.0e}), grad_norm rel {errs['grad_norm']:.2e} (step 0 "
            f"{first['grad_norm']:.2e}; bound {MESH_FULL_GNORM_RTOL:.0e}): {held}")


def lm_mesh_full_width(dev, card: str) -> dict:
    """[lm mesh] 2: h2o-danube-1.8b whole on a (2, 2) "tp" mesh of the card,
    its attention split by heads, its MLP by hidden units, its head and
    loss by vocab entries (``_full_width_steps``), against the unmeshed
    step, 3 steps each.  In bf16 with fp32 masters on the reference's
    draws: each step's metrics, times and tokens/s both ways, peak memory,
    the state's bytes per grid position against the dry-run's, the leaves
    gathered across ``model`` (none: 32 and 8 heads, an ``ff`` of 6,912 and
    a vocab of 32,000 all divide 2), every position's work, a profile of
    one more meshed step; loss and grad_norm at the MESH_FULL bounds or,
    past them, at the one-ulp witness (these draws' bf16 gradient is
    decided by rounding: one weight moved one ulp moved grad_norm 1.46e-2
    on the card).  Again in bf16 on weights of each layer's own fan-in
    (well conditioned), and in float32 on the reference's draws, each the
    same way (Adam's first update moves each weight by about ``lr`` times
    the sign of its gradient, and a gradient within rounding of zero may
    take either sign, so steps 1-2 part further than step 0)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    cfg = get_config("h2o-danube-1.8b")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bf = _full_width_steps(cfg, dev, card, profile=True)
    meshed, flat = bf["meshed"], bf["flat"]
    for i, (a, b) in enumerate(zip(meshed, flat)):
        for label, m in (("unmeshed (microbatches 2)", b), ("(2, 2) tp mesh (microbatches 1)", a)):
            print(f"[lm mesh] h2o-danube-1.8b bf16 step {i}, {label}: loss {m['loss']:.6f} "
                  f"grad_norm {m['grad_norm']:.6f}; {m['host_ms']:.1f} ms host clock, "
                  f"{m['dev_ms']:.1f} ms CUDA events, {tokens / m['host_ms'] * 1e3:,.0f} "
                  f"tokens/s | {card}")
    held = _full_width_held("bf16", cfg, bf, dev, fan_in=False)
    step_ms = statistics.median(m["host_ms"] for m in meshed[1:])
    flat_ms = statistics.median(m["host_ms"] for m in flat[1:])
    print(f"[lm mesh] h2o-danube-1.8b bf16 (fp32 masters) at {TRAIN_BATCH} x {TRAIN_SEQ}, remat "
          f"full, the reference's draws, 3 steps each from one initial state: the (2, 2) tp mesh "
          f"against unmeshed, {held}; median of steps 1-2 {step_ms:.1f} ms meshed "
          f"({statistics.median(m['dev_ms'] for m in meshed[1:]):.1f} ms CUDA events, "
          f"{tokens / step_ms * 1e3:,.0f} tokens/s) against {flat_ms:.1f} ms unmeshed "
          f"({statistics.median(m['dev_ms'] for m in flat[1:]):.1f} ms CUDA events, "
          f"{tokens / flat_ms * 1e3:,.0f} tokens/s); peak memory "
          f"{bf['mesh_peak'] / 2**30:.2f} GiB meshed, {bf['flat_peak'] / 2**30:.2f} GiB "
          f"unmeshed (max_memory_allocated) | {card}")
    per_pos, args = bf["per_pos"], bf["args"]
    batch_bytes = args - per_pos[0]
    print(f"[lm mesh] h2o-danube-1.8b train state on the (2, 2) mesh: {per_pos[0]:,} bytes a grid "
          f"position ({per_pos[0] / 1e9:.2f} GB; the dry-run's argument bytes for this mesh and "
          f"shape {args:,}, of which the batch {batch_bytes:,}), {sum(per_pos) / 1e9:.2f} GB over "
          f"the {len(per_pos)} positions against {H2O_STATE_GB} GB whole | {card}")
    print(f"{bf['gathered_line']}; own-block reads a position over the 3 steps {bf['reads']} "
          f"| {card}")
    check(not bf["gathered"], f"[lm mesh] h2o-danube-1.8b gathered across model: {bf['gathered']}")
    check(set(bf["reads"]) == set(bf["positions"]),
          f"[lm mesh] h2o-danube-1.8b: positions without work: {bf['reads']}")
    check(len(set(per_pos)) == 1, f"[lm mesh] the positions hold different bytes: {per_pos}")
    check(0 <= batch_bytes <= TRAIN_BATCH * TRAIN_SEQ * 4,
          f"[lm mesh] state bytes {per_pos[0]} against the dry-run's {args}")
    check(abs(sum(per_pos) / 1e9 - H2O_STATE_GB) < 0.01,
          f"[lm mesh] state {sum(per_pos) / 1e9:.3f} GB, not {H2O_STATE_GB}")
    del bf

    fi = _full_width_steps(cfg, dev, card, profile=False, fan_in=True)
    held = _full_width_held("bf16 fan-in", cfg, fi, dev, fan_in=True)
    print(f"[lm mesh] h2o-danube-1.8b bf16 (fp32 masters) at {TRAIN_BATCH} x {TRAIN_SEQ}, weights "
          f"of each layer's own fan-in, 3 steps each: the (2, 2) tp mesh against unmeshed, "
          f"losses {[round(m['loss'], 6) for m in fi['meshed']]} against "
          f"{[round(m['loss'], 6) for m in fi['flat']]}, {held}; median step "
          f"{statistics.median(m['host_ms'] for m in fi['meshed'][1:]):.1f} ms meshed against "
          f"{statistics.median(m['host_ms'] for m in fi['flat'][1:]):.1f} ms; "
          f"{len(fi['gathered'])} leaves gathered | {card}")
    check(not fi["gathered"] and set(fi["reads"]) == set(fi["positions"]),
          "[lm mesh] h2o-danube-1.8b fan-in: a leaf gathered or a position idle")
    del fi

    f32cfg = dataclasses.replace(cfg, dtype=torch.float32)
    f32 = _full_width_steps(f32cfg, dev, card, profile=False)
    held = _full_width_held("float32", f32cfg, f32, dev, fan_in=False)
    print(f"[lm mesh] h2o-danube-1.8b float32 at {TRAIN_BATCH} x {TRAIN_SEQ}, the reference's "
          f"draws, 3 steps each: the (2, 2) tp mesh against unmeshed, losses "
          f"{[round(m['loss'], 6) for m in f32['meshed']]}, grad_norms "
          f"{[round(m['grad_norm'], 4) for m in f32['meshed']]} against "
          f"{[round(m['grad_norm'], 4) for m in f32['flat']]}; {held}; median step "
          f"{statistics.median(m['host_ms'] for m in f32['meshed'][1:]):.1f} ms meshed against "
          f"{statistics.median(m['host_ms'] for m in f32['flat'][1:]):.1f} ms; "
          f"peak {f32['mesh_peak'] / 2**30:.2f} and {f32['flat_peak'] / 2**30:.2f} GiB; "
          f"{len(f32['gathered'])} leaves gathered | {card}")
    check(not f32["gathered"] and set(f32["reads"]) == set(f32["positions"]),
          "[lm mesh] h2o-danube-1.8b float32: a leaf gathered or a position idle")
    return {"step_ms": step_ms, "flat_ms": flat_ms}


def _first_differences(a, b) -> list:
    """Per row, the first step where two token arrays differ (None: equal)."""
    return [next((j for j in range(a.shape[1]) if a[i, j] != b[i, j]), None)
            for i in range(a.shape[0])]


def _decode_logits(params, cfg, tokens, dev, mesh=None):
    """The logits of each decode step [T, B, V] fed ``tokens`` [B, T] one
    position at a time (the cache laid out on ``mesh`` where one is given),
    and a callable that runs one more decode step on that cache."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.train.serve_step import decode

    b, t = tokens.shape
    cache = tfm.init_decode_cache(b, cfg, t + 2 - t % 2, dev, mesh=mesh)   # even: split by seq
    out = []
    with torch.no_grad():
        for i in range(t):
            logits, cache = decode(params, tokens[:, i:i + 1], cache, i, cfg, mesh=mesh)
            out.append(logits.float())

    def one_more():
        with torch.no_grad():
            decode(params, tokens[:, -1:], cache, t, cfg, mesh=mesh)

    return torch.stack(out), one_more


def _hold_bf16_tokens(cfg, model, store, mesh, prompts, got, want, dev, card: str,
                      profile: bool) -> str:
    """bf16 decode on the (1, 2) serve_tp mesh, fed the unmeshed generate's
    tokens: its logits at every step within the one-ulp witness (WITNESS_K
    times the largest shift of the unmeshed decode on ``_nudged`` weights),
    and its greedy token the unmeshed one wherever the unmeshed logits' top
    two are more than twice that apart; the free-running tokens where they
    first part.  With ``profile``, one more decode step both ways under
    the profiler.  Returns the readings."""
    import copy

    import torch

    seq = torch.cat([prompts, want], 1)
    plen = prompts.shape[1]
    base, flat_step = _decode_logits(model, cfg, seq, dev)
    split, mesh_step = _decode_logits(store, cfg, seq, dev, mesh=mesh)
    if profile:
        _profile_once("lm mesh decode step (1, 2) serve_tp, bf16 batch 4", mesh_step, card)
        _profile_once("lm decode step unmeshed, bf16 batch 4", flat_step, card)
    shift = torch.zeros(base.shape[:2], device=dev)
    draws = []
    for seed in range(WITNESS_DRAWS):
        nudged = _nudged(copy.deepcopy(model), seed)
        d = (_decode_logits(nudged, cfg, seq, dev)[0] - base).abs().amax(-1)
        shift, _ = torch.stack([shift, d]).max(0)
        draws.append(float(d.max()))
        del nudged
    err = (split - base).abs().amax(-1)                          # [T, B]
    check(bool((err <= WITNESS_K * shift).all()),
          f"[lm mesh] bf16 serve_tp decode: logits {float(err.max()):.3g} apart, past "
          f"{WITNESS_K} x the one-ulp witness at a step")
    top2 = base[plen - 1:-1].topk(2, -1).values                   # the generated steps
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > 2 * WITNESS_K * shift[plen - 1:-1]
    agree = split[plen - 1:-1].argmax(-1) == want.T
    check(bool(agree[decided].all()),
          "[lm mesh] bf16 serve_tp decode: another greedy token where the unmeshed one is "
          "decided past rounding")
    firsts = _first_differences(got, want)
    at = [(r, i) for r, i in enumerate(firsts) if i is not None]
    parts = [f"row {r} step {i}: top-2 margin {float(margin[i, r]):.3g} against the witness "
             f"{float(shift[plen - 1 + i, r]):.3g}" for r, i in at]
    return (f"fed the unmeshed tokens, logits at most {float(err.max()):.3g} apart (the unmeshed "
            f"decode's own one-ulp shifts {[f'{x:.3g}' for x in draws]}); greedy tokens equal at "
            f"{int(agree[decided].sum())} of {int(decided.sum())} steps decided past "
            f"{2 * WITNESS_K:g} x the witness ({int(agree.sum())} of {agree.numel()} in all); "
            f"free-running, " + ("the tokens equal" if not at else
                                 "rows part at " + "; ".join(parts)))


def lm_mesh_generate(dev, card: str) -> None:
    """[lm mesh] 3: h2o-danube-1.8b whole, ``generate`` (batch 4, prompt 32,
    16 new tokens, greedy) on a (1, 2) "serve_tp" mesh of the card, weights
    read in place (split by heads, hidden units and vocab entries) and the
    cache laid out by ``cache_shardings`` (``k``/``v`` split by ``seq``):
    decode ms a step both ways, the tokens, and the cache bytes each
    position holds against the dry-run's for this mesh and shape.  In
    float32 the tokens of the unmeshed ``generate``, held.  In bf16 the
    reference's draws' logits hold exact ties (a 1-ulp gap or none at many
    steps), which any float order but the unmeshed one's may break the
    other way: held by ``_hold_bf16_tokens`` (with a profile of one decode
    step both ways), and again on weights of each layer's own fan-in,
    where rounding decides fewer tokens."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import generate
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.prng import prng_key
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import cache_shardings, cache_specs, model_decls
    from repro_torch.models import transformer as tfm
    from repro_torch.models.base import init_params
    from repro_torch.sharding.blocks import shard_params

    b, plen, gen = 4, 32, 16
    for dtype, fan_in in ((torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)):
        cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), dtype=dtype)
        name = ("bf16" if dtype == torch.bfloat16 else "float32") + (" fan-in" if fan_in else "")
        model = init_params(model_decls(cfg, fan_in=fan_in),
                            prng_key(SEED, dev))
        prompts = torch.from_numpy(np.random.default_rng(SEED + 42).integers(
            0, cfg.vocab_size, (b, plen)).astype(np.int32)).to(dev)
        with _sharding_profile("serve_tp"):
            mesh = make_test_mesh(*MESH_SERVE, device=dev)
            store = shard_params(model, cfg, mesh)
            ms = {}
            for label, run in (("unmeshed", lambda: generate(cfg, model, prompts, gen)),
                               ("meshed", lambda: generate(cfg, store, prompts, gen, mesh=mesh))):
                run()
                torch.cuda.synchronize()
                t = time.perf_counter()
                ms[label] = (run(), (time.perf_counter() - t) * 1e3 / (plen + gen))
            cache = tfm.init_decode_cache(b, cfg, plen + gen, dev, mesh=mesh)
            shape = ShapeConfig("decode", plen + gen, b, "decode")
            want = dryrun.shard_bytes(cache_specs(cfg, shape), cache_shardings(cfg, shape, mesh))
            held = [cache.nbytes_at(p) for p in cache.positions]
            seq = cache.specs["0.k"]
            same = torch.equal(ms["meshed"][0], ms["unmeshed"][0])
            if dtype == torch.float32:
                tokens = "equal the unmeshed generate's" if same else "differ (held equal)"
            else:
                tokens = _hold_bf16_tokens(cfg, model, store, mesh, prompts, ms["meshed"][0],
                                           ms["unmeshed"][0], dev, card, profile=not fan_in)
        print(f"[lm mesh] h2o-danube-1.8b {name} generate on a (1, 2) serve_tp mesh (batch {b}, "
              f"prompt {plen}, {gen} new, greedy): tokens {tokens}; "
              f"decode {ms['meshed'][1]:.2f} ms a step meshed against {ms['unmeshed'][1]:.2f} ms "
              f"unmeshed (host clock over {plen + gen} steps) | {card}")
        print(f"[lm mesh] h2o-danube-1.8b {name} decode cache on the (1, 2) serve_tp mesh (k/v "
              f"spec {seq}): {held} bytes a position against the dry-run's {want:,} for this "
              f"mesh and shape; " + _gathered_line("generate", store)[len("[lm mesh] "):]
              + f" | {card}")
        check(held == [want] * len(held),
              f"[lm mesh] cache bytes {held} against the dry-run's {want}")
        check(seq[2] == "model", f"[lm mesh] the cache is not split by seq: {seq}")
        check(not store.gathered and set(store.local_reads) == set(store.positions),
              f"[lm mesh] generate: gathered {store.gathered}, reads {dict(store.local_reads)}")
        if dtype == torch.float32:
            check(same, "[lm mesh] meshed float32 generate gave other tokens than the unmeshed one")
        del model, store, cache
        torch.cuda.empty_cache()


def lm_mesh_dryrun(card: str) -> None:
    """[lm mesh] dryrun: h2o-danube-1.8b x train_4k on both production
    meshes: argument bytes a device against the card's memory, and the
    dominant roofline term (analytic, at the H100's ceilings)."""
    import torch

    from repro_torch.launch.dryrun import lower_cell

    total = torch.cuda.get_device_properties(0).total_memory
    with _sharding_profile("tp"):
        for multi_pod in (False, True):
            r = lower_cell("h2o-danube-1.8b", "train_4k", multi_pod)
            t = r["roofline"]
            print(f"[lm mesh] dryrun h2o-danube-1.8b x train_4k on {r['mesh']} ({r['chips']} "
                  f"devices, microbatches {r['microbatches']}): argument bytes "
                  f"{r['memory']['argument_bytes']:,} a device ({r['memory']['argument_bytes'] / 1e9:.3f} GB) "
                  f"against {total / 1e9:.1f} GB on this card; dominant {t['dominant']} "
                  f"(compute {t['compute_s']:.3e} s, memory {t['memory_s']:.3e} s, collective "
                  f"{t['collective_s']:.3e} s; compile_s {r['compile_s']}) | {card}")
            check(r["memory"]["argument_bytes"] < total, "[lm mesh] dryrun: the state does not fit")


def main() -> int:
    t_start = time.perf_counter()
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
    from repro_torch.core.booleanize import adaptive_gaussian_booleanize, threshold_booleanize
    from repro_torch.core.cotm import init_boundary_model
    from repro_torch.core.ingress import apply_ingress
    from repro_torch.core.patches import PatchSpec, pack_bits
    from repro_torch.core.prng import prng_key
    from repro_torch.kernels import _build, ops, registry
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.paths import get_path
    from repro_torch.serve.servable import analyze_sparsity, freeze

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- 1. environment and build ------------------------------------------
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    parent_procs = start_parent_build(_build)
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    parent_dir = finish_parent_build(parent_procs) if parent_procs else None
    build_s = time.perf_counter() - t
    print(f"[env] built {list(_build.SOURCES)} in {build_s:.2f} s"
          f"{' (and the parent commit from _parent/)' if parent_dir else ''}")
    ops_per_s, mma_per_s = ceilings()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[env] integer ceiling {ops_per_s:.4g} results/s "
          f"({sms} SMs x {INT32_PER_CLOCK_PER_SM}/clock x max SM clock)")
    print(f"[env] int8 tensor-core ceiling {mma_per_s:.4g} multiply-adds/s ({sms} SMs x "
          f"{INT8_MMA_PER_CLOCK_PER_SM}/clock x max SM clock; {2 * mma_per_s / 1e12:.0f} TOPS "
          f"at 2 operations each, against the data sheet's 1,979 TOPS dense)")
    for name, log in _build.PTXAS_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    # The model pools of the main paths (convcotm-mnist at full width).
    arch = "convcotm-mnist"
    cfg = COTM_CONFIGS[arch]
    method = BOOLEANIZE_METHOD[arch]
    model = init_boundary_model(prng_key(SEED), cfg)
    # A boundary model includes about half its literals, so no clause fires
    # on any image and every class sum is 0.  A pool with a few includes per
    # clause, as trained pools have, fires.  From it, a seeded ~40% of the
    # clauses are emptied, so the active pool is smaller than C and not a
    # multiple of 32; and an all-empty pool, whose class sums are all 0.
    g = torch.Generator().manual_seed(SEED + 1)
    few = torch.rand(tuple(model.ta_state.shape), generator=g) < 3.0 / cfg.n_literals
    few_model = type(model)(
        ta_state=torch.where(few, 133, 123).to(torch.uint8), weights=model.weights.clone())
    ta40 = few_model.ta_state.clone()
    ta40[:, 0] = 133                                     # every clause nonempty ...
    ta40[torch.rand(cfg.n_clauses, generator=g) < 0.4] = 0   # ... then ~40% empty
    few40_model = type(model)(ta_state=ta40, weights=model.weights.clone())
    empty_model = type(model)(ta_state=torch.zeros_like(ta40), weights=model.weights.clone())
    pools = {"boundary": model, "few40": few40_model, "empty": empty_model}
    n_active = {k: int(freeze(m, cfg).nonempty.sum()) for k, m in pools.items()}
    print(f"[pools] active clauses C_a of C={cfg.n_clauses}: {n_active}")
    check(n_active["boundary"] == cfg.n_clauses, "boundary pool has an empty clause")
    check(0 < n_active["few40"] < cfg.n_clauses and n_active["few40"] % 32,
          f"few-include pool: C_a={n_active['few40']} is not a non-multiple of 32 below C")
    check(n_active["empty"] == 0, "all-empty pool has an active clause")

    # --- 2. kernels against their plain versions ----------------------------
    phase_s = {"1 environment and build": time.perf_counter() - t_start}
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_bits(shape, p_one):
        return (torch.rand(shape, generator=gen, device=dev) < p_one).to(torch.uint8)

    ingress_specs = {
        "paper": PatchSpec(),
        "noisy_xor": PatchSpec(image_x=4, image_y=4, window_x=2, window_y=2),
        "stride2": PatchSpec(image_x=12, image_y=12, window_x=4, window_y=4,
                             stride_x=2, stride_y=2),
        "whole_image": PatchSpec(image_x=11, image_y=9, window_x=11, window_y=9),
        "wide": PatchSpec(image_x=48, image_y=20, window_x=36, window_y=6,
                          stride_x=3, stride_y=2),
        # P*W = 3025 x 13 words, past the kernel's shared tile: the patch
        # loop runs in chunks.
        "chunked": PatchSpec(image_x=64, image_y=64, window_x=10, window_y=10),
    }
    for name, spec in ingress_specs.items():
        for b in (1, 5, 256):
            imgs = rand_bits((b, spec.image_y, spec.image_x), 0.4)
            got = ops.ingress_pack(imgs, spec)
            want = ops.ingress_pack(imgs, spec, backend="plain")
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"ingress_pack differs from plain: {name} B={b}")
        print(f"[kernel] ingress_pack == plain: {name} (B=1,5,256)")
    # The adaptive mode: raw pixels (integer planes, on which the exact
    # local mean is the pixel itself, so at c = 0 its last bit decides, and
    # noise) against the plain twin, at windows that take each branch of
    # the window sum.
    for name, spec in ingress_specs.items():
        yy, xx = torch.meshgrid(torch.arange(spec.image_y, device=dev),
                                torch.arange(spec.image_x, device=dev), indexing="ij")
        raw = torch.randint(0, 256, (256, spec.image_y, spec.image_x), generator=gen,
                            device=dev, dtype=torch.uint8)
        raw[0], raw[1], raw[2] = (yy + 2 * xx) % 256, (200 - 3 * yy // 2 - xx) % 256, 77
        for block_size, c in ADAPTIVE_WINDOWS:
            for cc in (c, 0.0):
                for b in (1, 5, 256):
                    got = ops.ingress_pack_adaptive(raw[:b], spec, block_size, cc)
                    want = ops.ingress_pack_adaptive(raw[:b], spec, block_size, cc,
                                                     backend="plain")
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"ingress_pack_adaptive differs from plain: "
                          f"{name} B={b} block {block_size} c {cc}")
        print(f"[kernel] ingress_pack_adaptive == plain: {name} (B=1,5,256; (block, c) "
              f"{ADAPTIVE_WINDOWS}, each also at c 0)")

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

    def active(inc_packed, ne, w):
        """The active pool as analyze_sparsity cuts it: exclude words of the
        nonempty clauses, and their weight columns."""
        idx = torch.nonzero(ne).flatten()
        return ~inc_packed[idx], w[:, idx]

    def equal_both_csrf(name, fn, args, block_cs=(128,)):
        want = fn(*args, backend="plain")
        for block_c in block_cs:
            for csrf in (True, False):
                got = fn(*args, csrf=csrf, block_c=block_c)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"{fn.__name__} differs from plain: {name} block_c={block_c} "
                      f"csrf={csrf}")

    tile_kernels = (ops.fused_infer, ops.clause_eval, ops.clause_eval_sparse,
                    ops.fused_infer_sparse)
    tuned_cases = ("4x361x128x272", "3x50x70x100", "2x361x1000x272")

    fused_cases = {f"{b}x{p}x{c}x{n}": (b, p, c, n, {}) for b, p, c, n in
                   [(4, 361, 128, 272), (1, 9, 16, 16), (3, 50, 70, 100),
                    (8, 64, 256, 512), (2, 361, 1000, 272)]}
    fused_cases["density0.0"] = (2, 30, 64, 128, dict(include_p=1.0))
    fused_cases["density1.0"] = (2, 30, 64, 128, dict(include_p=0.0))
    fused_cases["saturating"] = (4, 361, 300, 272, dict(include_p=0.002, lit_p=1.0))
    fused_cases["envelope"] = (2, 2048, 1024, 8192, dict(m=64))
    for name, (b, p, c, n, kw) in fused_cases.items():
        lits, incp, ne, w = fused_inputs(b, p, c, n, **kw)
        exc, wa = active(incp, ne, w)
        # The test shapes also at the autotuner's block_c (more tiles, whose
        # partial class sums meet in int32 atomics).
        block_cs = (128,) + (TUNED_BLOCK_C if name in tuned_cases else ())
        for fn, args in zip(tile_kernels, ((lits, incp, ne, w), (lits, incp, ne),
                                           (lits, exc), (lits, exc, wa))):
            equal_both_csrf(name, fn, args, block_cs)
        print(f"[kernel] fused_infer, clause_eval, clause_eval_sparse, fused_infer_sparse "
              f"== plain: {name} (C_a={exc.shape[0]}; block_c {list(block_cs)}; csrf on, "
              f"off)")

    # The active pool at C_a = 0, 1 and 37 (paper geometry, few includes),
    # and analyze_sparsity images padded with synthetic rows.
    lits, incp, ne, w = fused_inputs(4, 361, 128, 272, include_p=3.0 / 272)
    exc, wa = active(incp, ne, w)
    for c_a in (0, 1, 37):
        args = (lits, exc[:c_a].contiguous(), wa[:, :c_a].contiguous())
        equal_both_csrf(f"C_a={c_a}", ops.clause_eval_sparse, args[:2])
        equal_both_csrf(f"C_a={c_a}", ops.fused_infer_sparse, args)
    sm40 = freeze(few40_model, cfg)
    lits = ops.ingress_pack(rand_bits((64, 28, 28), 0.3), cfg.patch)
    pads = ("pow2", n_active["few40"] + 3)
    for pad_to in pads:
        sp = analyze_sparsity(sm40, pad_to=pad_to).sparsity.to(dev)
        args = (lits, sp.exclude_packed, sp.weights)
        equal_both_csrf(f"pad_to={pad_to}", ops.clause_eval_sparse, args[:2])
        equal_both_csrf(f"pad_to={pad_to}", ops.fused_infer_sparse, args)
        check(bool(ops.clause_eval_sparse(*args[:2])[:, n_active["few40"]:].all()),
              "a synthetic pad row did not fire")
    print(f"[kernel] clause_eval_sparse, fused_infer_sparse == plain: C_a = 0, 1, 37; "
          f"analyze_sparsity of C_a={n_active['few40']} with pad_to {list(pads)} "
          f"(csrf on, off)")
    # The few40 and empty pools as the engine holds them, at B=256, at
    # every block_c the autotuner sweeps (C_a = 88: two tiles of 64, three
    # of 32).
    lits256 = ops.ingress_pack(rand_bits((256, 28, 28), 0.3), cfg.patch)
    for pool in ("few40", "empty"):
        sv = analyze_sparsity(freeze(pools[pool], cfg)).to(dev)
        sp = sv.sparsity
        for fn, args in zip(tile_kernels, (
                (lits256, sv.include_packed, sv.nonempty, sv.weights),
                (lits256, sv.include_packed, sv.nonempty),
                (lits256, sp.exclude_packed), (lits256, sp.exclude_packed, sp.weights))):
            equal_both_csrf(f"{pool} pool B=256", fn, args, (128,) + TUNED_BLOCK_C)
        print(f"[kernel] fused_infer, clause_eval, clause_eval_sparse, fused_infer_sparse "
              f"== plain: {pool} pool B=256 (C_a={sp.n_active}; block_c "
              f"{[128, *TUNED_BLOCK_C]}; csrf on, off)")

    # Random bits, and one-hot fired rows against weights that differ in
    # every (class, clause): each sum is then one weight, so a swapped
    # row, class or clause in an mma fragment changes it.
    class_sum_geoms = ((256, 128, 10), (3, 70, 10), (2, 1024, 64), (256, 1000, 10),
                       (17, 88, 10), (300, 128, 10), (1, 1, 1), (40, 3004, 20))
    for b, c, m in class_sum_geoms:
        rows = torch.arange(b, device=dev)
        onehot = torch.zeros((b, c), dtype=torch.uint8, device=dev)
        onehot[rows, (rows * 7) % c] = 1
        ramp = (torch.arange(m * c, device=dev).reshape(m, c) % 255 - 127).to(torch.int8)
        for kind, fired, w in (
            ("random", rand_bits((b, c), 0.5),
             torch.randint(-127, 128, (m, c), generator=gen, device=dev, dtype=torch.int32)),
            ("one-hot", onehot, ramp),
        ):
            want = ops.class_sum(fired, w, backend="plain")
            for f in (fired, fired.to(torch.bool)):
                got = ops.class_sum(f, w)
                torch.cuda.synchronize()
                check(got.dtype == torch.int32 and torch.equal(got, want),
                      f"class_sum differs from plain: B={b} C={c} M={m} {kind} fired {f.dtype}")
    print(f"[kernel] class_sum == plain: (B,C,M) = "
          f"{', '.join(str(g).replace(' ', '') for g in class_sum_geoms)} "
          f"(random and one-hot fired, uint8 and bool)")

    # --- 2b. the threefry kernel: known answers, == plain, times ------------
    phase_s["2 kernels == plain"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    threefry_row = prng_phase(dev, card, ops_per_s)
    phase_s["2b prng"] = time.perf_counter() - t_phase

    # --- 3a. main path of slice 1: the engine on the fused path --------------
    t_phase = time.perf_counter()
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
    for name in SLICE1_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the fused path")

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

    for label, path, eng in (("fused", "fused", engine), ("dense", "dense", engine),
                             ("cpu", "fused", cpu)):
        eng.register(f"{arch}/few/{label}", few_model, cfg, booleanize_method=method,
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

    # --- 3b. main paths of slice 2: kernel and the clause-sparsity paths -----
    placed = {}
    for pool, m in pools.items():
        for path in SLICE2_PATHS + ("dense",):
            placed[pool, path] = engine.register(f"{arch}/{pool}/{path}", m, cfg,
                                                 booleanize_method=method, path=path)
            check(engine.resolved_path(f"{arch}/{pool}/{path}") == path,
                  f"{pool}/{path} resolves to {engine.resolved_path(f'{arch}/{pool}/{path}')}")
        for path in SLICE2_PATHS:
            cpu.register(f"{arch}/{pool}/{path}", m, cfg, booleanize_method=method, path=path)
    spec_packed = get_path("kernel").ingress_spec(cfg.patch, method=method)
    on_card = [torch.from_numpy(r).to(dev) for r in requests]
    torch.cuda.synchronize()

    registry.reset_launches()
    served = {(pool, path, i): engine.classify(f"{arch}/{pool}/{path}", r)
              for pool in pools for i, r in enumerate(requests) for path in SLICE2_PATHS}
    launches2 = registry.launch_counts()
    print(f"[engine] launches during classify on {list(SLICE2_PATHS)}: {launches2}")
    for name in ("ingress_pack", "clause_eval", "clause_eval_sparse", "fused_infer_sparse"):
        check(launches2[name] > 0, f"kernel {name} was not launched on the slice-2 paths")
    check(launches2["class_sum"] == 0 and launches2["fused_infer"] == 0,
          "a slice-2 path launched class_sum or the dense fused kernel")

    # No path calls class_sum (the JAX package has none): it is driven on
    # the fired bits that clause_eval gives for the same requests, in a
    # window of its own, and must equal the kernel path's class sums.
    registry.reset_launches()
    summed = {}
    for pool in pools:
        sm = placed[pool, "kernel"]
        for i in range(len(requests)):
            fired = ops.clause_eval(apply_ingress(spec_packed, on_card[i]),
                                    sm.include_packed, sm.nonempty)
            summed[pool, i] = ops.class_sum(fired, sm.weights).cpu().numpy()
    launches3 = registry.launch_counts()
    print(f"[engine] launches of class_sum over clause_eval's fired bits: {launches3}")
    check(launches3["class_sum"] > 0, "kernel class_sum was not launched")

    for pool in pools:
        for i, (n, r) in enumerate(zip(sizes, requests)):
            dense = engine.classify(f"{arch}/{pool}/dense", r)
            check(np.array_equal(summed[pool, i], served[pool, "kernel", i].class_sums),
                  f"{pool}, request of {n}: class_sum over clause_eval differs from the "
                  f"kernel path")
            for path in SLICE2_PATHS:
                res = served[pool, path, i]
                check(res.class_sums.shape == (n, cfg.n_classes)
                      and res.class_sums.dtype == np.int32, f"{pool}/{path}: bad result")
                plain = cpu.classify(f"{arch}/{pool}/{path}", r)
                for other, label in ((dense, "dense path on the card"),
                                     (plain, "plain composition on the CPU")):
                    check(np.array_equal(res.predictions, other.predictions)
                          and np.array_equal(res.class_sums, other.class_sums),
                          f"{pool}, request of {n}: {path} differs from the {label}")
            sums = served[pool, "kernel", i].class_sums
            if pool == "empty":
                check(not sums.any(), "all-empty pool: a class sum is not 0")
            if pool == "few40":
                check(bool(sums.any()), "few-include pool: every class sum is 0")
        print(f"[engine] {pool} pool (C_a={n_active[pool]}): {', '.join(SLICE2_PATHS)} "
              f"== dense (card) == plain (CPU), and class_sum(clause_eval) == kernel path, "
              f"on requests of {list(sizes)}")

    # --- 3c. main paths of the adaptive ingress, the trainer and the hand-off -
    phase_s["3a-3b fused, kernel and sparse paths"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    launches_adaptive = adaptive_serving(engine, cpu, {"few": few_model, "few40": few40_model},
                                  registry, dev)
    trainer_card_equals_cpu(dev)
    launches_trained, launches_fit, trained = trainer_on_card(engine, registry, dev, card)
    tm_resume_card_to_cpu(dev, card)

    # --- 3d. the serving stack: lifecycle, service, chaos, lifecycle round --
    phase_s["3c adaptive, trainer, hand-off"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    svc_pools = {"a": few40_model, "b": few_model}
    engine_lifecycle(cfg, method, svc_pools, trained, dev)
    launches_storm = service_swap_storm(cfg, method, svc_pools, registry, card)
    launches_chaos = service_chaos(cfg, method, svc_pools, cpu, registry, card)
    launches_round = lifecycle_round(cfg, method, trained, registry, card)

    # --- 3e. the autotuner, its plans through the lifecycle, the roofline ---
    phase_s["3d service"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    tuned, launches_autotune = autotune_serving(cfg, method, pools, cpu, registry, card)
    autotune_lifecycle(cfg, method, {"few": few_model}, tuned, trained, card)
    roofline_lines(cfg, tuned, requests[3], requests[0], ops_per_s, card)

    # --- 3f. the device mesh: cuda:0 repeated -----------------------------
    phase_s["3e autotune and roofline"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # The unmeshed fused kernel (B=256, boundary pool) on the same inputs
    # just before and just after the mesh phase: whether the phase moves
    # phase 4's kernel times.
    g_probe = torch.Generator(device=dev).manual_seed(SEED + 23)
    probe_lits = ops.ingress_pack(
        (torch.rand((256, 28, 28), generator=g_probe, device=dev) < 0.3).to(torch.uint8),
        cfg.patch)
    sv = placed["boundary", "kernel"]
    probe = lambda: ops.fused_infer(probe_lits, sv.include_packed, sv.nonempty,  # noqa: E731
                                    sv.weights)
    before_mesh = time_ms(probe, inner=20)[0]
    launches_mesh = mesh_serving(cfg, method, pools, cpu, registry, dev, card)
    launches_mesh_svc = mesh_service_and_tuning(cfg, method, pools, registry, dev, card)
    mesh_training(dev, card)
    after_mesh = time_ms(probe, inner=20)[0]
    print(f"[time] fused_infer B=256 boundary pool around the [mesh] phase (same inputs): "
          f"before {before_mesh:.5f} ms, after {after_mesh:.5f} ms | {card}")

    # --- 4. times at bucket 256 ----------------------------------------------
    phase_s["3f mesh"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    b = 256
    spec = cfg.patch
    raw = torch.from_numpy(rng.integers(0, 256, (b, 28, 28), dtype=np.uint8)).to(dev)
    bool_imgs = threshold_booleanize(raw, 75)
    lits = ops.ingress_pack(bool_imgs, spec)
    p, w, c, m = spec.n_patches, spec.n_words, cfg.n_clauses, cfg.n_classes
    lit_bytes = b * p * w * 4
    # Each tile kernel on two pools: boundary (C_a = C, nothing fires, and
    # every clause fails on its first word of every patch) and few40
    # (clauses fire, C_a = 88).  The class sums take few40's fired bits.
    # A case: (kernel, pool, kernel call, plain call, (bytes, operations)).
    # Bytes: each input read once, each output written once.  Operations:
    # one per output word (ingress), one LOP3 per word test these inputs
    # need (tile kernels), one multiply-add per (image, class, clause)
    # (class sums, over the int8 tensor-core ceiling).
    # The adaptive mode reads the raw pixels where the bits mode reads the
    # booleanized ones: the same bytes and words; its float work (2 x 21
    # operations a pixel at 11 taps) is 0.13 us at 67 TFLOP/s, below both.
    cases = [("ingress_pack", None,
              lambda: ops.ingress_pack(bool_imgs, spec),
              lambda: ops.ingress_pack(bool_imgs, spec, backend="plain"),
              (b * spec.image_y * spec.image_x + lit_bytes, b * p * w)),
             ("ingress_pack_adaptive", None,
              lambda: ops.ingress_pack_adaptive(raw, spec),
              lambda: ops.ingress_pack_adaptive(raw, spec, backend="plain"),
              (b * spec.image_y * spec.image_x + lit_bytes, b * p * w))]
    # The route the adaptive mode replaces on the card: the booleanize as
    # torch operations, then the bits mode.
    compositions = {"ingress_pack_adaptive": lambda: ops.ingress_pack(
        adaptive_gaussian_booleanize(raw), spec)}
    c_as = {}
    # The dense tile kernels at the autotuner's other block_c, timed in the
    # same windows beside their default (128).
    by_block_c = {}
    for pool in ("boundary", "few40"):
        sv = placed[pool, "kernel"]
        sp = placed[pool, "fused_sparse"].sparsity
        c_a = c_as[pool] = sp.n_active
        dense_tests = fused_word_tests(lits, sv.include_packed, sv.nonempty)
        sparse_tests = fused_word_tests(lits, ~sp.exclude_packed,
                                        torch.ones(c_a, dtype=torch.bool, device=dev))
        for name, args, cost in (
            ("fused_infer", (lits, sv.include_packed, sv.nonempty, sv.weights),
             (lit_bytes + c * w * 4 + c + m * c + b * m * 4, dense_tests)),
            ("fused_infer_sparse", (lits, sp.exclude_packed, sp.weights),
             (lit_bytes + c_a * w * 4 + m * c_a + b * m * 4, sparse_tests)),
            ("clause_eval", (lits, sv.include_packed, sv.nonempty),
             (lit_bytes + c * w * 4 + c + b * c, dense_tests)),
            ("clause_eval_sparse", (lits, sp.exclude_packed),
             (lit_bytes + c_a * w * 4 + b * c_a, sparse_tests)),
        ):
            fn = getattr(ops, name)
            cases.append((name, pool, lambda fn=fn, a=args: fn(*a),
                          lambda fn=fn, a=args: fn(*a, backend="plain"), cost))
            by_block_c[name, pool] = lambda bc, fn=fn, a=args: fn(*a, block_c=bc)
    # The class sums on two inputs: few40's fired bits (the paper's C=128,
    # M=10) and the envelope (C=1024, M=64: seeded bits at density 0.5,
    # int8 weights over the full range).  Each has two library yardsticks,
    # their inputs made once outside the windows: an f32 torch.matmul and
    # torch._int_mm (int8 x int8 -> int32, classes padded to 16).
    s40 = placed["few40", "kernel"]
    fired40 = ops.clause_eval(lits, s40.include_packed, s40.nonempty)
    env_c, env_m = 1024, 64
    class_sum_inputs = {
        "few40": (fired40, s40.weights),
        "envelope": (rand_bits((b, env_c), 0.5),
                     torch.randint(-128, 128, (env_m, env_c), generator=gen, device=dev,
                                   dtype=torch.int8)),
    }
    libraries = {}
    for pool, (fired, wts) in class_sum_inputs.items():
        nc, nm = wts.shape[1], wts.shape[0]
        f32 = (fired.to(torch.float32), wts.to(torch.float32).t().contiguous())
        w_pad = torch.zeros((-(-nm // 16) * 16, nc), dtype=torch.int8, device=dev)
        w_pad[:nm] = wts
        i8 = (fired.view(torch.int8), w_pad.t())
        want = ops.class_sum(fired, wts)
        torch.cuda.synchronize()
        check(torch.equal(torch.matmul(*f32).to(torch.int32), want),
              f"torch.matmul class sums differ from the class_sum kernel ({pool})")
        try:
            check(torch.equal(torch._int_mm(*i8)[:, :nm], want),
                  f"torch._int_mm class sums differ from the class_sum kernel ({pool})")
            int_mm = lambda i8=i8: torch._int_mm(*i8)          # noqa: E731
        except RuntimeError as e:
            print(f"[time] torch._int_mm refuses the class sums ({pool}, B={b} C={nc} "
                  f"M={nm} padded to {w_pad.shape[0]}): {e}")
            int_mm = None
        libraries["class_sum", pool] = (lambda f32=f32: torch.matmul(*f32), int_mm)
        cases.append(("class_sum", pool, lambda a=(fired, wts): ops.class_sum(*a),
                      lambda a=(fired, wts): ops.class_sum(*a, backend="plain"),
                      (b * nc + nm * nc + b * nm * 4, b * nm * nc)))

    def launch_floor() -> float:
        """ms per call of a kernel that does nothing, in the same windows."""
        return time_ms(lambda: torch.cuda._sleep(0), inner=20)[0]

    floors = [launch_floor()]
    rows = []
    for name, pool, fn, plain_fn, (nbytes, nops) in cases:
        got, want = fn(), plain_fn()
        # The parent's turns, where its build has this kernel's entry point.
        parent = parent_dir
        if parent:
            with _build.libraries_from(parent_dir):
                try:
                    old_out = fn()
                except AttributeError:          # ctypes: no such symbol there
                    parent = None
            if parent:
                torch.cuda.synchronize()
                check(torch.equal(old_out, want),
                      f"the parent's {name} differs from plain ({pool})")
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
        check(err == 0, f"{name} ({pool}) differs from plain at B=256: {err}")
        # Turns: parent, this tree, this tree, parent.
        t_new, t_old, unheld = [], [], []
        for turn in ("parent", "new", "new", "parent"):
            if turn == "parent" and not parent:
                continue
            with (_build.libraries_from(parent) if turn == "parent"
                  else contextlib.nullcontext()):
                t, held = time_ms(fn, inner=20)
            (t_old if turn == "parent" else t_new).append(t)
            if not held:
                unheld.append("parent_ms" if turn == "parent" else "ms")
        ms = statistics.mean(t_new)
        parent_ms = statistics.mean(t_old) if t_old else None
        block_c_ms = None
        if name in ("fused_infer", "clause_eval"):
            block_c_ms = {"128": ms}
            for bc in TUNED_BLOCK_C:
                out = by_block_c[name, pool](bc)
                torch.cuda.synchronize()
                check(torch.equal(out, want), f"{name} ({pool}) block_c={bc} differs from "
                      f"plain at B=256")
                block_c_ms[str(bc)] = time_ms(lambda bc=bc: by_block_c[name, pool](bc),
                                              inner=20)[0]
            print(f"[time] {name} B={b} {pool} pool by block_c: "
                  f"{', '.join(f'{k} {v:.5f} ms' for k, v in block_c_ms.items())}")
        composition_ms = None
        if name in compositions:
            check(torch.equal(compositions[name](), want),
                  f"{name}: the composition it replaces differs from plain")
            composition_ms, held = time_ms(compositions[name], inner=20)
            if not held:
                unheld.append("composition_ms")
        plain_ms, plain_held = time_ms(plain_fn, inner=3, repeats=5, warmup=1)
        matmul_fn, int_mm_fn = libraries.get((name, pool), (None, None))
        library_ms, lib_held = time_ms(matmul_fn, inner=20) if matmul_fn else (None, True)
        int_mm_ms, int_mm_held = time_ms(int_mm_fn, inner=20) if int_mm_fn else (None, True)
        unheld += [k for k, h in (("plain_ms", plain_held), ("library_ms", lib_held),
                                  ("int_mm_ms", int_mm_held)) if not h]
        # The class sums' multiply-adds run on the int8 tensor cores; the
        # other kernels' word tests and words have no tensor-core form.
        bound_ms, bound_by = bound(nbytes, nops,
                                   mma_per_s if name == "class_sum" else ops_per_s)
        # Launches on the main paths: every serving drive; class_sum, which
        # no path calls, from its own window.
        adaptive_trained = launches_adaptive[name] + launches_trained[name]
        service = launches_storm[name] + launches_chaos[name] + launches_round[name]
        mesh = launches_mesh[name] + launches_mesh_svc[name]
        main_path = (launches[name] + launches2[name] + adaptive_trained + service
                     + launches_autotune[name] + mesh)
        count = launches3[name] if name == "class_sum" else main_path
        k = registry.KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "pool": pool, "launches": count, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            # Launches by the serving drives alone (class_sum: 0, its
            # "launches" come from its own window).
            "main_path_launches": main_path,
            # Of those, the launches of the adaptive serving drive and of
            # the trained model's (fused, fused_sparse, infer_packed).
            "adaptive_trained_launches": adaptive_trained,
            # Of those, the launches of the service drives (swap storm,
            # chaos soak, lifecycle round).
            "service_launches": service,
            # Of those, the launches of the tuned drive (the autotuner's
            # sweep at every block_c/csrf set, then the tuned classifies).
            "autotune_launches": launches_autotune[name],
            # Of those, the launches of the mesh drives (the six meshes and
            # Table III's, the meshed service and the tuned meshed engine).
            "mesh_launches": mesh,
            # ms at each block_c (fused_infer, clause_eval; else null).
            "block_c_ms": block_c_ms,
            # torch._int_mm on the same bits (class sums; null where it
            # refuses the shape or for the other kernels).
            "int_mm_ms": int_mm_ms,
            # The route the kernel replaces, on the same inputs (the
            # adaptive ingress: the booleanize's torch operations, then
            # the bits mode; else null).
            "composition_ms": composition_ms,
            # A kernel that does nothing, in the same windows (mean of the
            # readings before and after the kernels; set below).
            "launch_floor_ms": None,
            # The parent commit's kernel on the same inputs, in turns with
            # this tree's (null without a parent export).
            "parent_ms": parent_ms,
            # The times above that include host gaps (see time_ms).
            "host_gaps_in": sorted(set(unheld)),
        })
        lib = (f", torch.matmul {library_ms:.5f} ms" if library_ms is not None else "") + (
            f", torch._int_mm {int_mm_ms:.5f} ms" if int_mm_ms is not None else "") + (
            f", composition (booleanize ops + bits mode) {composition_ms:.5f} ms"
            if composition_ms is not None else "")
        old = (f", parent {parent_ms:.5f} ms (turns {', '.join(f'{x:.5f}' for x in t_old)}; "
               f"this tree {', '.join(f'{x:.5f}' for x in t_new)})" if t_old else "")
        where = (f" envelope (C={env_c} M={env_m})" if pool == "envelope"
                 else f" {pool} pool" if pool else "")
        print(f"[time] {name} B={b}{where}"
              f"{f' (C_a={c_as[pool]})' if 'sparse' in name else ''}: kernel {ms:.5f} ms"
              f"{old}, plain {plain_ms:.5f} ms{lib}, bound {bound_ms:.3g} ms "
              f"({bound_by}: {nbytes} B, {nops} ops)"
              f"{f'; host gaps in {sorted(set(unheld))}' if unheld else ''}")

    floors.append(launch_floor())
    floor_ms = statistics.mean(floors)
    for row in rows:
        row["launch_floor_ms"] = floor_ms
    print(f"[time] launch floor: {floor_ms:.5f} ms per call of torch.cuda._sleep(0) "
          f"(before the kernels {floors[0]:.5f}, after {floors[1]:.5f}; windows of 20)")

    # How often CSRF can end a clause's patch walk early on this pool: a
    # clause stops at the first patch group where it fires.
    live = fired40[:, s40.nonempty.to(torch.bool)]
    print(f"[csrf] few40 pool, B={b}: {int(live.sum())} of {live.numel()} (image, active "
          f"clause) pairs fire and stop early; {int(live.all(dim=1).sum())} of {b} images "
          f"fire all {c_as['few40']} active clauses; {int((live.sum(dim=0) == 0).sum())} "
          f"active clauses fire on no image")

    imgs256, img1 = requests[3], requests[0]
    sparse_name = f"{arch}/boundary/fused_sparse"
    engine.warmup(sparse_name)
    for label, name in (("fused", arch), ("fused_sparse", sparse_name),
                        ("fused_sparse", sparse_name), ("fused", arch)):
        print(f"[time] classify {label} (boundary pool): "
              f"{classify_times(engine, name, imgs256, img1)}")
    for label, name in (("fused", arch), ("fused_sparse", sparse_name)):
        for blabel, imgs, reps in (("bucket 256", imgs256, 20), ("bucket 1", img1, 50)):
            profile_classify(engine, name, imgs, reps, f"{label} {blabel}")
    phase_s["4 times and profiles"] = time.perf_counter() - t_phase

    # --- 5. the LM substrate's serving path -----------------------------------
    # It has no kernel of its own: the six TM kernels' counters stay at 0;
    # threefry draws the weights drawn on the card and the sampled tokens.
    t_phase = time.perf_counter()
    registry.reset_launches()
    lm_card_against_cpu(dev, card)
    lm_full_width_stepwise(dev, card)
    lm_roofline(lm_served(dev, card), card)
    lm_launches = registry.launch_counts()
    print(f"[engine] launches during the [lm] phase: {lm_launches}")
    check(not any(v for k, v in lm_launches.items() if k != "threefry")
          and lm_launches["threefry"] > 0,
          f"the LM path launched a TM kernel, or drew nothing on the card: {lm_launches}")
    phase_s["5 lm"] = time.perf_counter() - t_phase

    # --- 6. the LM substrate's training path ----------------------------------
    # Plain PyTorch as well: the six TM kernels' counters stay at 0 (threefry
    # draws the weights drawn on the card).
    t_phase = time.perf_counter()
    registry.reset_launches()
    lm_train_card_against_cpu(dev, card)
    lm_train_full_width_fp32(dev, card)
    lm_train_roofline(lm_train_run(dev, card), card)
    lm_train_resume(dev, card)
    train_launches = registry.launch_counts()
    print(f"[engine] launches during the [lm train] phase: {train_launches}")
    check(not any(v for k, v in train_launches.items() if k != "threefry")
          and train_launches["threefry"] > 0,
          f"the LM training path launched a TM kernel, or drew nothing on the card: "
          f"{train_launches}")
    phase_s["6 lm train"] = time.perf_counter() - t_phase

    # --- 7. the LM substrate over a mesh --------------------------------------
    # Meshes of the card repeated; plain PyTorch: the TM counters stay at 0
    # (threefry draws the weights drawn on the card).
    t_phase = time.perf_counter()
    registry.reset_launches()
    lm_mesh_reduced(dev, card)
    lm_mesh_full_width(dev, card)
    lm_mesh_generate(dev, card)
    lm_mesh_dryrun(card)
    mesh_lm_launches = registry.launch_counts()
    print(f"[engine] launches during the [lm mesh] phase: {mesh_lm_launches}")
    check(not any(v for k, v in mesh_lm_launches.items() if k != "threefry")
          and mesh_lm_launches["threefry"] > 0,
          f"the meshed LM path launched a TM kernel, or drew nothing on the card: "
          f"{mesh_lm_launches}")
    phase_s["7 lm mesh"] = time.perf_counter() - t_phase

    # --- 8. Kimi Linear's KDA decode kernel, and its model on the card --------
    t_phase = time.perf_counter()
    registry.reset_launches()
    kda_row = lm_kda(dev, card)
    kda_launches = registry.launch_counts()
    print(f"[engine] launches during the [lm kda] phase: {kda_launches}")
    check(not any(v for k, v in kda_launches.items() if k != "threefry")
          and kda_launches["threefry"] > 0,
          f"the Kimi Linear path launched a TM kernel, or drew nothing on the card: "
          f"{kda_launches}")
    phase_s["8 lm kda"] = time.perf_counter() - t_phase

    # --- 9. the decode step's GQA attention kernel, and danube on the card ----
    t_phase = time.perf_counter()
    registry.reset_launches()
    gqa_row = lm_gqa(dev, card)
    gqa_launches = registry.launch_counts()
    print(f"[engine] launches during the [lm gqa] phase: {gqa_launches}")
    check(not any(v for k, v in gqa_launches.items() if k != "threefry")
          and gqa_launches["threefry"] > 0,
          f"the danube decode path launched a TM kernel, or drew nothing on the card: "
          f"{gqa_launches}")
    phase_s["9 lm gqa"] = time.perf_counter() - t_phase
    print(f"[env] phase seconds: {', '.join(f'{k} {v:.2f}' for k, v in phase_s.items())}")
    print(f"[env] {card} | build {build_s:.2f} s")

    # The threefry row: its launches are the trainer's fit on the card (the
    # main path of the draws); the LM phases' draws on the card beside.
    threefry_row["launches"] = launches_fit["threefry"]
    threefry_row["lm_launches"] = {"lm": lm_launches["threefry"],
                                   "lm train": train_launches["threefry"],
                                   "lm mesh": mesh_lm_launches["threefry"],
                                   "lm kda": kda_launches["threefry"],
                                   "lm gqa": gqa_launches["threefry"]}
    threefry_row["launch_floor_ms"] = floor_ms
    kda_row["launch_floor_ms"] = gqa_row["launch_floor_ms"] = floor_ms
    rows += [threefry_row, kda_row, gqa_row]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
