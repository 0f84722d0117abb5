"""One run of one cell: find its parts by name, build the inputs and the
system from the seed, drive the traffic, judge the answers, read the
metrics.

The parts are found by the names in ``BENCHMARK.json``, so a cell,
configuration, traffic mix or metric is added with new files and entries:

  * a configuration: the JSON file its entry names (``file``); its
    ``system`` key names the system that runs it (``convcotm`` when the
    key is absent);
  * a system: ``portbench/systems/<system>.py``;
  * a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind``
    names its generator, ``portbench/loads/<kind>.py``;
  * a metric: ``portbench/metrics/<metric>.py``, whose ``read(rec)``
    returns the number, or None when the run holds nothing to read it
    from (the metric is then left out of the line).

New files are enough for a configuration of a system that has its module.
A system module defines

  * ``make(cfg, streams, name, device) -> (engine, pool, inputs)``: the
    inputs and the model from the seed's streams (:func:`rngs`), the
    system under test built on ``device`` (``engine``), what the load
    generator draws its requests from (``pool``, or None), and what the
    judge needs (``inputs``: the model and the inputs, never the
    program's own state);
  * ``judge(run, trace, log) -> (checks, facts)``: the reference's
    answers worked out from ``run.inputs`` and the numbers compared,
    ``{name: {"value": v, "limit": l}}`` or ``{"min": m}`` (the result
    is correct when every value is within its limit or at least its
    min), and the facts its metric readers need besides the outcome's,
    which join ``rec.facts``; it runs once the system under test is freed
    and the memory peak read;
  * for ``control.py``: ``controls(cfg)``, the names of its controls, and
    ``control_checks(run, kind)``, the same checks as ``judge``'s with
    that control in the program's place (:func:`checks_pass` says whether
    it passes).

A generator module defines ``run(ctx, seconds, trace) -> Outcome``: it
warms up the shapes its traffic uses, stamps ``ctx.window_start`` when it
sends the first timed request, drives the window, and with ``trace``
drives a further stretch of the same traffic under the profiler
(:data:`TRACE_SECONDS`, or what the mix states).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from harness import guard

__all__ = ["Context", "Outcome", "Record", "ROOT", "Run", "TRACE_SECONDS", "execute", "run_cell"]

#: The checkout's root: ``BENCHMARK.json`` and ``src/`` are there.
ROOT = Path(__file__).resolve().parents[2]
#: Length of the traced stretch that follows the window in a ``--trace 1`` run.
TRACE_SECONDS = 1.0
#: A request refused, failed or never answered counts at this latency:
#: beyond any limit, since no run lasts 1,000 s.
FAIL_MS = 1e6
#: Seed streams: one generator each, so that adding draws to one leaves
#: the others alone.
STREAM_POOL, STREAM_MODEL, STREAM_TRAFFIC = 1, 2, 3


@dataclasses.dataclass
class Context:
    """What a load generator gets: the system under test (``engine``), the
    inputs its requests are drawn from (``pool``), the traffic."""

    engine: Any
    name: str
    cfg: Dict
    traffic: Dict
    pool: Optional[np.ndarray]
    rng: np.random.Generator
    window_start: Optional[float] = None     # perf_counter at the first timed request


@dataclasses.dataclass
class Outcome:
    """What a load generator measured.  ``answers`` are every answer
    received, in the form its system's judge reads (ConvCoTM: pool
    indices, class sums ``[n, M]``, predictions ``[n]``, how many times
    this answer came); ``missing`` counts requests admitted but never
    answered, ``inconsistent`` answer rows that differed from an earlier
    answer to the same image.  ``facts`` holds what a system's generator
    measured for that system's judge and readers alone, by a name of its
    own (the LM decode: ``tokens_in_window``, ``steps_in_window``, ...), so
    that a new system adds a fact without a field here."""

    attempted: int
    failed: int
    missing: int
    answers: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]
    window_s: float
    inconsistent: int = 0
    latencies_ms: Optional[np.ndarray] = None       # every request due in the window
    due_s: Optional[np.ndarray] = None              # when each was due, from the window's start
    late_ms: Optional[np.ndarray] = None            # how late each was sent
    images_in_window: Optional[int] = None          # results back inside the window
    window_pool_idx: Optional[np.ndarray] = None    # their pool indices
    dispatch_s: Optional[np.ndarray] = None         # benchmark's clock around dispatch()
    service_images: Optional[int] = None
    service_batches: Optional[int] = None
    trace: Any = None                               # trace.TraceData
    traced_calls: Optional[List[np.ndarray]] = None  # pool indices per traced engine call
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)  # the system's own, by name


@dataclasses.dataclass
class Record(Outcome):
    """An outcome with what the readers need besides: set-up time, the
    configuration, the card's ceilings, and in ``facts`` what the system's
    judge adds (ConvCoTM: ``word_tests``, the reference's word tests per
    pool image, in traced runs)."""

    setup_s: float = 0.0
    cfg: Dict = dataclasses.field(default_factory=dict)
    card: Optional[Dict] = None


def load_benchmark(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path):
    """Load ``path`` as a module of its own (metric names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: Dict, root: Path, workload: str):
    """(cell entry, configuration, traffic, generator module) by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    kind = _module(root / "portbench" / "loads" / f"{traffic['kind']}.py")
    return cell, cfg, traffic, kind


def cell_metrics(bench: Dict, cell: str) -> Tuple[List[Dict], List[Dict]]:
    """The end-to-end and per-layer metrics this cell reports: those that
    list it, or list no cells (a per-layer metric then goes wherever the
    end-to-end metric it moves is reported)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def reader(root: Path, metric: str):
    return _module(root / "portbench" / "metrics" / f"{metric}.py").read


def rngs(seed: int) -> Dict[int, np.random.Generator]:
    s = seed % (1 << 64)
    return {k: np.random.default_rng([s, k]) for k in (STREAM_POOL, STREAM_MODEL, STREAM_TRAFFIC)}


def system(root: Path, cfg: Dict):
    """The module of the system that runs ``cfg``."""
    return _module(root / "portbench" / "systems" / f"{cfg.get('system', 'convcotm')}.py")


def checks_pass(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["min"]
               for c in checks.values())


@dataclasses.dataclass
class Run:
    """What one drive of a cell left: its metrics, its system's module, the
    inputs and model (``inputs``, as the system made them) and the outcome."""

    cfg: Dict
    layer: List[Dict]
    e2e: List[Dict]
    system: Any
    inputs: Any
    outcome: Outcome
    setup_s: float
    memory_peak_bytes: int
    device: Any


def execute(workload: str, seed: int, seconds: float, trace: bool, *, proc_start: float,
            device="cuda", root: Path = ROOT, overrides: Optional[Dict] = None) -> Run:
    """Build the inputs, the model and the system from ``seed``, drive the
    cell's traffic, read the memory peak, and free the system.
    ``overrides`` replaces entries of the configuration (``cfg``) and the
    traffic (``traffic``), for tests at small sizes."""
    import torch

    bench = load_benchmark(root)
    _, cfg, traffic, kind = find_cell(bench, root, workload)
    cfg.update((overrides or {}).get("cfg", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    e2e, layer = cell_metrics(bench, workload)
    sysmod = system(root, cfg)
    r = rngs(seed)
    dev = torch.device(device)
    engine, pool, inputs = sysmod.make(cfg, r, workload, dev)
    ctx = Context(engine=engine, name=workload, cfg=cfg, traffic=traffic, pool=pool,
                  rng=r[STREAM_TRAFFIC])
    outcome = kind.run(ctx, seconds, trace)
    setup_s = ctx.window_start - proc_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Run(cfg=cfg, layer=layer, e2e=e2e, system=sysmod, inputs=inputs, outcome=outcome,
               setup_s=setup_s, memory_peak_bytes=int(peak), device=dev)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, proc_start: float,
             device="cuda", root: Path = ROOT, overrides: Optional[Dict] = None,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> Dict:
    """One run; returns the result line's object (``checks`` last)."""
    import torch

    run = execute(workload, seed, seconds, trace, proc_start=proc_start, device=device,
                  root=root, overrides=overrides)
    outcome, cfg, dev = run.outcome, run.cfg, run.device
    wanted = run.layer if trace else run.e2e
    readers = {m["name"]: reader(root, m["name"]) for m in wanted}
    on_card = dev.type == "cuda"

    checks, facts = run.system.judge(run, trace, log)
    card = None
    if on_card:
        from harness.card import card_facts

        card = card_facts()
        log(f"card: {card}")
    rec = Record(**{f.name: getattr(outcome, f.name) for f in dataclasses.fields(Outcome)},
                 setup_s=run.setup_s, cfg=cfg, card=card)
    rec.facts = {**outcome.facts, **facts}
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](rec)
        if v is None:
            if m in run.e2e:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if outcome.late_ms is not None and len(outcome.late_ms):
        log(f"load generator late: p50 {np.percentile(outcome.late_ms, 50):.4f} ms, "
            f"p99 {np.percentile(outcome.late_ms, 99):.4f} ms, "
            f"max {outcome.late_ms.max():.4f} ms")
    out = {
        "correct": checks_pass(checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    if trace and outcome.trace is not None:
        tr = outcome.trace
        log(f"trace: {len(tr.device)} device and {len(tr.host)} host events over "
            f"{tr.window_s:.3f} s, read in {tr.read_s:.3f} s")
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    if card is not None:
        out["card"] = {k: card[k] for k in ("name", "power_limit_w", "max_sm_clock_mhz",
                                            "sm_clock_mhz", "sms", "int_ops_per_s")}
    out["checks"] = checks
    bad = guard.forbidden_modules(list(sys.modules))
    if bad:
        raise ImportError(f"modules of JAX or the JAX package were loaded: {bad}")
    return out
