"""The readings that set a cell's limits: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... --seconds 3

For each seed, one process drives the cell's traffic at its own load for
a short window (as a benchmark run does, without its metrics), judges
what the program answered against the plain reference (the program's
readings: every number its system compares), then puts each control of
the cell's system in the program's place for the same answers: the
reference computed one precision below what the configuration states.
ConvCoTM: ``int4`` (the int8 weights quantized to int4) in every cell,
and ``bf16`` (the adaptive booleanize's float32 local mean in bfloat16)
where the configuration booleanizes adaptively; the LM decode:
``fp8_e4m3`` (every matrix and the embedding rounded to float8 e4m3).
Each side's checks are those of the system's judge, and each side is
judged by them as a run is (``correct``): the program has to pass on every
seed, each control has to fail on every seed.  Prints one line per seed
and a JSON summary (each number's largest program reading and each
control's smallest; whether the program passed on every seed, and
whether a control passed on any).  Run on the card; the benchmark's own
runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def readings(workload: str, seeds, seconds: float, device, root: Path, overrides=None,
             log=print) -> dict:
    """Per seed, the program's checks and each control's, each with
    ``correct`` as the benchmark decides it (:func:`harness.cell.checks_pass`)."""
    from harness.cell import checks_pass, execute

    out = {"workload": workload, "seconds": seconds, "program": {}, "control": {}}
    for seed in seeds:
        t = time.perf_counter()
        run = execute(workload, seed, seconds, False, proc_start=t, device=device, root=root,
                      overrides=overrides)
        checks, _ = run.system.judge(run, False, lambda s: None)
        out["program"][seed] = {"correct": checks_pass(checks), "checks": checks}
        row = {"seed": seed, "program": out["program"][seed]}
        for kind in run.system.controls(run.cfg):
            c = run.system.control_checks(run, kind)
            out["control"].setdefault(kind, {})[seed] = {"correct": checks_pass(c), "checks": c}
            row[f"control_{kind}"] = out["control"][kind][seed]
        row["wall_s"] = time.perf_counter() - t
        log("[control] " + json.dumps(row))

    def values(per):
        return [{k: c["value"] for k, c in r["checks"].items()} for r in per.values()]

    progs = values(out["program"])
    out["program_correct"] = all(r["correct"] for r in out["program"].values())
    out["program_max"] = {k: max(p[k] for p in progs) for k in progs[0]}
    out["control_min"], out["control_correct_on_any_seed"] = {}, {}
    for kind, per in out["control"].items():
        reads = values(per)
        out["control_min"][kind] = {k: min(r[k] for r in reads) for k in reads[0]}
        out["control_correct_on_any_seed"][kind] = any(r["correct"] for r in per.values())
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
