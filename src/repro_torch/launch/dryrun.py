"""Dry-run of every (arch x shape x mesh) cell: the port's counterpart of
``repro/launch/dryrun.py``.

For each cell the step's abstract arguments are laid out on the
production mesh, the (16, 16) single pod or the (2, 16, 16) two pods,
over the ``meta`` device (``launch/mesh.py:make_production_mesh``): the
train state and batch of a train cell, the parameters and batch of a
prefill cell, the parameters, token, cache and position of a decode cell
(``launch/specs.py``), each with its sharding.  Nothing is allocated, so
all 68 cells run on a CPU in seconds.

The result keeps the reference's JSON keys.  There is no XLA here, so:

* ``compile_s`` is ``null``: nothing is compiled;
* ``memory.argument_bytes`` and ``memory.output_bytes`` are exact per
  device: each leaf's ``shard_shape`` times its itemsize, summed (the
  outputs: the new state and the float32 metrics of a train step, the
  float32 logits sharded ``("batch", "tensor")`` and the new cache of a
  decode step, those logits of a prefill);
* ``memory.bytes_per_device`` and ``memory.peak_bytes`` are ``null``: they
  are XLA's temporaries, which only a compiler can give;
* ``roofline`` is ``roofline.analysis.roofline_terms`` at the H100's
  ceilings over the analytic cost: ``flops_estimate / chips``,
  ``hbm_bytes_estimate``, and ``collective_bytes_estimate`` at the cell's
  data, model and pod sizes, microbatches and profile in place of the
  HLO's collectives (its ``collectives`` are keyed by mechanism: fsdp, tp,
  pod, ep);
* ``useful_flops_ratio`` is the ideal model FLOPs over that analytic
  count, where the reference divides by the HLO's.

Results are written one JSON per cell under ``$REPRO_DRYRUN_DIR``
(``experiments/dryrun`` by default) and are skipped when present unless
``--force``.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all \\
      [--multi-pod | --both] [--force] [--cells N]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Any, Dict, Iterable, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, TrainConfig, applicable_shapes, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.flops import (
    collective_bytes_estimate,
    flops_estimate,
    hbm_bytes_estimate,
)
from repro_torch.sharding.partition import set_profile, sharding_for

__all__ = ["cell_bytes", "cell_path", "lower_cell", "main", "shard_bytes"]


def out_dir() -> str:
    return os.environ.get("REPRO_DRYRUN_DIR", "experiments/dryrun")


def _pairs(tree, shardings) -> Iterable:
    """``(tensor, sharding)`` over two trees of one structure."""
    if isinstance(tree, torch.Tensor):
        yield tree, shardings
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, shardings[k])
    else:
        for v, s in zip(tree, shardings):
            yield from _pairs(v, s)


def shard_bytes(tree, shardings) -> int:
    """Bytes one grid position holds of ``tree`` laid out by ``shardings``."""
    return sum(math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
               for t, sh in _pairs(tree, shardings))


def cell_bytes(cfg, shape, mesh, microbatches: int = 1) -> Tuple[int, int]:
    """(argument bytes, output bytes) one position of ``mesh`` holds for a
    cell of ``shape``: a train step's state and batch in, state and three
    float32 metrics out; a prefill's parameters and batch in, float32
    last-position logits out; a decode step's parameters, token, cache and
    int32 position in, logits and the new cache out.  The logits are
    sharded ``("batch", "tensor")``."""
    logits = torch.empty((shape.global_batch, cfg.vocab_size), dtype=torch.float32,
                         device="meta")
    l_bytes = shard_bytes(logits, sharding_for(tuple(logits.shape), ("batch", "tensor"), mesh))
    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches)
        state = shard_bytes(S.abstract_train_state(cfg, tcfg), S.state_shardings(cfg, tcfg, mesh))
        batch = shard_bytes(S.batch_specs(cfg, shape), S.batch_shardings(cfg, shape, mesh))
        return state + batch, state + 3 * 4      # loss, grad_norm, lr: float32, replicated
    params = shard_bytes(dict(S.abstract_model(cfg).named_parameters()),
                         S.param_shardings(cfg, mesh))
    if shape.kind == "prefill":
        return (params + shard_bytes(S.batch_specs(cfg, shape),
                                     S.batch_shardings(cfg, shape, mesh)), l_bytes)
    cache, c_sh = S.cache_specs(cfg, shape), S.cache_shardings(cfg, shape, mesh)
    toks = (shape.global_batch, 1)
    t_bytes = math.prod(sharding_for(toks, ("batch", None), mesh).shard_shape(toks)) * 4
    new_cache = (shard_bytes(cache["self"], c_sh["self"]) if cfg.is_encoder_decoder
                 else shard_bytes(cache, c_sh))
    return params + t_bytes + shard_bytes(cache, c_sh) + 4, l_bytes + new_cache


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    cfg_override=None,
    profile: str | None = None,
) -> Dict[str, Any]:
    """One cell's record (the reference's keys; see the module docstring
    for the fields that are ``null`` and why).  Sets the sharding profile,
    as the reference does."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    # Decode cells use decode-resident weights ('serve_tp') unless the arch
    # prefers pure DP; train and prefill follow the arch's profile.
    if profile is None:
        if shape.kind == "decode":
            profile = "serve_tp" if cfg.sharding_profile != "dp" else "dp"
        else:
            profile = cfg.sharding_profile
    set_profile(profile)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    k = S.microbatches_for(cfg, shape, mesh) if shape.kind == "train" else 1
    args, outs = cell_bytes(cfg, shape, mesh, k)
    extra: Dict[str, Any] = {"microbatches": k} if shape.kind == "train" else {}
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)

    dims = mesh.shape
    coll = collective_bytes_estimate(
        cfg, shape, dp=dims["data"], tp=dims["model"], pods=dims.get("pod", 1),
        microbatches=k, profile=profile)
    cost = {"flops": flops_estimate(cfg, shape) / chips,
            "bytes accessed": hbm_bytes_estimate(cfg, shape, chips, microbatches=k)}
    terms = roofline_terms(cost, chips=chips, collectives={
        mech: {"wire_bytes": v} for mech, v in coll.items() if mech != "total"})

    n = cfg.param_count()
    na = cfg.active_param_count()
    ideal = model_flops(n, na, tokens, shape.kind)
    ideal_per_chip = ideal / chips
    analytic = terms["flops_per_chip"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "kind": shape.kind,
        "compile_s": None,
        "params": n,
        "active_params": na,
        "tokens_per_step": tokens,
        "model_flops_total": ideal,
        "model_flops_per_chip": ideal_per_chip,
        "useful_flops_ratio": ideal_per_chip / analytic if analytic else None,
        "memory": {
            "bytes_per_device": None,
            "argument_bytes": args,
            "output_bytes": outs,
            "peak_bytes": None,
        },
        "roofline": terms,
        **extra,
    }


def cell_path(arch: str, shape: str, multi_pod: bool) -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    return os.path.join(out_dir(), f"{arch}__{shape}__{mesh}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true", help="run both meshes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cells", type=int, default=0, help="stop after N cells")
    args = ap.parse_args(argv)

    os.makedirs(out_dir(), exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    meshes = [False, True] if args.both else [args.multi_pod]

    done = failed = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = applicable_shapes(cfg) if args.shape == "all" else [args.shape]
        for shape in shapes:
            for mp in meshes:
                path = cell_path(arch, shape, mp)
                if os.path.exists(path) and not args.force:
                    print(f"skip {path} (exists)")
                    continue
                print(f"=== laying out {arch} x {shape} x "
                      f"{'2x16x16' if mp else '16x16'} ===", flush=True)
                try:
                    res = lower_cell(arch, shape, mp)
                except Exception as e:  # noqa: BLE001 - recorded per cell, run goes on
                    failed += 1
                    print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
                    with open(path + ".err", "w") as f:
                        f.write(traceback.format_exc())
                else:
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    r, m = res["roofline"], res["memory"]
                    print(
                        f"  OK argument_bytes={m['argument_bytes']:,} "
                        f"output_bytes={m['output_bytes']:,} dominant={r['dominant']} "
                        f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                        f"collective={r['collective_s']:.3e}s "
                        f"useful={res['useful_flops_ratio']}",
                        flush=True,
                    )
                    done += 1
                if args.cells and done + failed >= args.cells:
                    print(f"done={done} failed={failed}")
                    return
    print(f"done={done} failed={failed}")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
