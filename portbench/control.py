"""The readings that set a cell's limits: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... --seconds 3

For each seed, one process drives the cell's traffic at its own load for
a short window (as a benchmark run does, without its metrics), judges
every answer against the plain reference (the program's reading: answers
that differ, plus answers that never came), then puts the control in the
program's place: the reference computed one precision below what the
configuration states, for the same answers.  Controls: ``int4`` (the
int8 weights quantized to int4) in every cell, and ``bf16`` (the adaptive
booleanize's float32 local mean in bfloat16) where the configuration
booleanizes adaptively.  Prints one line per seed and a JSON summary
(the largest program reading, the smallest control reading).  Run on the
card; the benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def controls(cfg) -> list:
    return ["int4"] + (["bf16"] if cfg["booleanize"]["method"] == "adaptive" else [])


def control_reading(outcome, cfg, run, kind: str, ref_sums, ref_preds, device) -> int:
    """Answers the control gives differently from the reference, over the
    same pool images the program answered."""
    from harness import reference

    c_sums, c_preds, _ = reference.classify(run.pool, cfg, run.ta, run.weights, device=device,
                                            control=kind)
    bad = 0
    for idx, _, _, times in outcome.answers:
        idx = np.asarray(idx)
        rows = (c_sums[idx] != ref_sums[idx]).any(axis=1) | (c_preds[idx] != ref_preds[idx])
        bad += int(rows.sum()) * times
    return bad


def readings(workload: str, seeds, seconds: float, device, root: Path, overrides=None,
             log=print) -> dict:
    from harness import reference
    from harness.cell import execute, judge

    out = {"workload": workload, "seconds": seconds, "program": {}, "control": {}}
    for seed in seeds:
        t = time.perf_counter()
        run = execute(workload, seed, seconds, False, proc_start=t, device=device, root=root,
                      overrides=overrides)
        sums, preds, _ = reference.classify(run.pool, run.cfg, run.ta, run.weights,
                                            device=run.device)
        checks = judge(run.outcome, sums, preds)
        out["program"][seed] = checks["bad_answers"]["value"]
        row = {"seed": seed, "compared": checks["answers_compared"]["value"],
               "program_bad": checks["bad_answers"]["value"]}
        for kind in controls(run.cfg):
            v = control_reading(run.outcome, run.cfg, run, kind, sums, preds, run.device)
            out["control"].setdefault(kind, {})[seed] = v
            row[f"control_{kind}_bad"] = v
        row["wall_s"] = time.perf_counter() - t
        log("[control] " + json.dumps(row))
    out["program_max"] = max(out["program"].values())
    out["control_min"] = {k: min(v.values()) for k, v in out["control"].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(1, str(root / "src"))
    import torch

    torch.set_num_threads(1)     # one process, few threads: no host op of the run needs more

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    out = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                   "cuda", root, log=lambda s: print(s, flush=True))
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
