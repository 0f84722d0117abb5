"""Find the highest rate an open-loop cell's service sustains: one process
builds the cell's system once and runs its traffic at each rate in turn.

    python3 portbench/sweep.py --workload mnist-overload --seed <n> --seconds 30 \\
        --rates 8000,12000,16000

A rate is sustained when no request is refused, fails or goes unanswered,
at least 99% of the window's requests are answered inside it, the median
latency of the window's last third is within twice that of its first
third, and the 99th percentile within four times the median: the queue
neither grows across the window nor backs up for 1% of its requests
(as it does behind the service's garbage-collection stalls).  The
highest sustained rate is the highest at which that rate and every lower
one were sustained in every pass.  Prints one line per rate and a JSON
summary: a cell below the knee runs at about 80% of it, an overload cell
at 1.5 times.  Run on the card; not part of the benchmark's own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def judge_rate(o, seconds: float) -> dict:
    lat = o.latencies_ms
    n = len(lat)
    third = max(1, n // 3)
    done = o.due_s * 1e3 + lat <= seconds * 1e3
    first, last = np.median(lat[:third]), np.median(lat[-third:])
    row = {
        "offered_per_s": n / seconds,
        "answered_in_window_per_s": float(done.sum()) / seconds,
        "failed": o.failed, "missing": o.missing,
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.sort(lat)[int(np.ceil(0.95 * n)) - 1]),
        "p99_ms": float(np.percentile(lat, 99)),
        "p50_first_third_ms": float(first), "p50_last_third_ms": float(last),
        "late_p99_ms": float(np.percentile(o.late_ms, 99)),
        "images_per_batch": o.service_images / max(o.service_batches, 1),
    }
    row["sustained"] = bool(o.failed == 0 and o.missing == 0 and done.mean() >= 0.99
                            and last <= 2 * first and row["p99_ms"] <= 4 * row["p50_ms"])
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(1, str(root / "src"))
    import torch

    torch.set_num_threads(1)     # one process, few threads: no host op of the run needs more

    from harness.cell import STREAM_TRAFFIC, Context, find_cell, load_benchmark, rngs, system

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell, cfg, traffic, kind = find_cell(load_benchmark(root), root, args.workload)
    r = rngs(args.seed)
    engine, pool, _ = system(root, cfg).make(cfg, r, args.workload, torch.device("cuda"))
    import gc

    pauses = []
    starts = {}

    def timer(phase, info):
        if phase == "start":
            starts[info["generation"]] = time.perf_counter()
        elif info["generation"] in starts:
            pauses.append((info["generation"], time.perf_counter() - starts[info["generation"]]))

    gc.callbacks.append(timer)
    rows = []
    for rate in (float(x) for x in args.rates.split(",")):
        pauses.clear()
        ctx = Context(engine=engine, name=args.workload, cfg=cfg,
                      traffic=dict(traffic, rate_per_s=rate), pool=pool,
                      rng=r[STREAM_TRAFFIC])
        t = time.perf_counter()
        row = {"rate_per_s": rate, **judge_rate(kind.run(ctx, args.seconds, False), args.seconds)}
        row["wall_s"] = time.perf_counter() - t
        g2 = [p for g, p in pauses if g == 2]
        row["gc"] = {"collections": len(pauses), "gen2": len(g2),
                     "gen2_max_ms": max(g2, default=0.0) * 1e3,
                     "all_max_ms": max((p for _, p in pauses), default=0.0) * 1e3}
        rows.append(row)
        print("[sweep] " + json.dumps(row), flush=True)
    failed = [x["rate_per_s"] for x in rows if not x["sustained"]]
    best = max((x["rate_per_s"] for x in rows
                if x["sustained"] and all(x["rate_per_s"] < f for f in failed)), default=None)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "highest_sustained_per_s": best, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
