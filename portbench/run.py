"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; inputs and model come from
``--seed``.  With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (a further
stretch of the traffic under ``torch.profiler`` follows the window).  The
last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last); the last lines on standard error are
the numbers compared, each with its limit.  Without a CUDA card, with
fewer cards than the cell asks for, without the port's sources under
``src/``, or with a module of JAX or of the JAX package loaded, it exits
with a nonzero code and prints no result.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_start() -> float:
    """When this process started, on the ``perf_counter`` clock (from
    ``/proc/self/stat``; where that cannot be read, when this module
    started)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")      # field 22: starttime
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        now = time.perf_counter()
        return now - age if 0 <= age < now - _T_START + 60 else _T_START
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_START


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    t0 = process_start()

    here = Path(__file__).resolve().parent
    root = here.parent
    sys.path[:0] = [str(here), str(root / "src")]
    from harness.cell import load_benchmark, run_cell

    cells = {w["name"]: w for w in load_benchmark(root)["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)     # one process, few threads: no host op of the run needs more

    want = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"this cell needs {want} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), proc_start=t0,
                   root=root)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"min {c['min']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
