"""The harness's parts: discovery by name, the contract's names and
units, the generators' schedules, the import guard, the trace and
metric arithmetic."""

import json
import math
import re
import shutil
import time

import numpy as np
import pytest

from harness import guard, readers
from harness.cell import ROOT, Record, cell_metrics, find_cell, load_benchmark, reader, run_cell
from harness.trace import TraceData, merge_intervals

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load(rel):
    from harness.cell import _module

    return _module(ROOT / "portbench" / rel)


def test_benchmark_json_keeps_to_the_contract():
    b = load_benchmark(ROOT)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in b["workloads"]:
        got_e2e, got_layer = cell_metrics(b, w["name"])
        assert "setup_s" in {m["name"] for m in got_e2e} and len(got_e2e) >= 2
        assert got_layer
        # A per-layer metric's cell reports the end-to-end metric it moves.
        for m in got_layer:
            assert m["moves"] in {e["name"] for e in got_e2e}, (w["name"], m["name"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = load_benchmark(ROOT)
    cfg = json.loads((ROOT / "portbench/configs/convcotm-mnist.json").read_text())
    cfg["booleanize"] = {"method": "threshold", "threshold": 100}
    (root / "portbench/configs/convcotm-mnist-t100.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/bulk-8x1.json").write_text(json.dumps(
        {"kind": "closed_loop_engine", "batch": 8, "outstanding": 1, "warm_calls": 1}))
    (root / "portbench/metrics/answers.per_call.py").write_text(
        "def read(rec):\n    return len(rec.answers) and sum(len(a[0]) for a in rec.answers)"
        " / len(rec.answers)\n")
    b["configs"].append({"name": "convcotm-mnist-t100", "source": "test",
                         "file": "portbench/configs/convcotm-mnist-t100.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "t100-bulk", "config": "convcotm-mnist-t100",
                           "traffic": "bulk-8x1", "chips": 1, "why": "test"})
    next(m for m in b["end_to_end"] if m["name"] == "cls_per_s")["workloads"].append("t100-bulk")
    b["per_layer"].append({"name": "answers.per_call", "unit": "images", "better": "higher",
                           "source": "program_counter", "layer": "engine (serve/engine.py)",
                           "moves": "cls_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell, cfg2, traffic, kind = find_cell(b, root, "t100-bulk")
    assert cfg2["booleanize"]["threshold"] == 100 and traffic["batch"] == 8
    e2e, layer = cell_metrics(b, "t100-bulk")
    assert {m["name"] for m in e2e} == {"cls_per_s", "setup_s"}
    assert [m["name"] for m in layer] == ["answers.per_call"]
    assert "answers.per_call" in {m["name"] for m in cell_metrics(b, "fmnist-bulk")[1]}
    out = run_cell("t100-bulk", 5, 0.5, True, proc_start=time.perf_counter(), device="cpu",
                   root=root, overrides={"cfg": {"pool_images": 32}}, log=lambda s: None)
    assert out["correct"] and out["metrics"]["answers.per_call"]["value"] == 8.0


def test_poisson_schedule_count_span_and_seed():
    ps = _load("loads/poisson_service.py")
    due, idx = ps.schedule(np.random.default_rng([9, 3]), 2000.0, 1.5, 100)
    assert len(due) == len(idx) == 3000
    assert math.isclose(due[-1], 1.5) and (np.diff(due) > 0).all() and due[0] > 0
    assert idx.min() >= 0 and idx.max() < 100
    again, _ = ps.schedule(np.random.default_rng([9, 3]), 2000.0, 1.5, 100)
    np.testing.assert_array_equal(due, again)
    other, _ = ps.schedule(np.random.default_rng([10, 3]), 2000.0, 1.5, 100)
    assert len(other) == len(due) and not np.array_equal(other, due)
    # The same set of gaps in another order.
    gaps = np.diff(np.concatenate([[0.0], due]))
    np.testing.assert_allclose(np.sort(gaps), np.sort(np.diff(np.concatenate([[0.0], other]))))
    assert 0.9 < gaps.std() / gaps.mean() < 1.1          # exponential: cv ~1


def test_closed_loop_batches_count_and_seed():
    cl = _load("loads/closed_loop_engine.py")
    b = cl.batches(np.random.default_rng(4), 4096, 256)
    assert b.shape == (16, 256) and sorted(b.reshape(-1)) == list(range(4096))
    np.testing.assert_array_equal(b, cl.batches(np.random.default_rng(4), 4096, 256))
    assert not np.array_equal(b, cl.batches(np.random.default_rng(5), 4096, 256))
    with pytest.raises(ValueError):
        cl.batches(np.random.default_rng(4), 10, 256)


def test_import_guard_compares_top_level_names_whole():
    names = ["repro.x", "repro_torch.x", "repro_torch", "jax", "jaxlib.xla_client",
             "flax.linen", "numpy", "jaxtyping", "reprox"]
    assert guard.forbidden_modules(names) == ["flax.linen", "jax", "jaxlib.xla_client",
                                              "repro.x"]
    assert guard.forbidden_modules(["repro_torch.serve.engine"]) == []


def _rec(**kw):
    base = dict(attempted=1, failed=0, missing=0, answers=[], window_s=2.0)
    base.update(kw)
    return Record(**base)


def test_trace_busy_gaps_and_device_ops():
    assert merge_intervals([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    tr = TraceData(start_us=0.0, end_us=100.0,
                   device=[("void (anonymous namespace)::fused_infer_kernel<false>(int)", 10, 20),
                           ("Memcpy HtoD (Pinned -> Device)", 15, 30),
                           ("ingress_pack_kernel(x)", 50, 60)],
                   host=[("portbench.outer", 0, 100), ("cudaEventSynchronize", 30, 50),
                         ("aten::cat", 60, 62)])
    assert math.isclose(tr.busy_s, 30e-6) and math.isclose(tr.window_s, 100e-6)
    assert tr.kernel("fused_infer_kernel") == (1, pytest.approx(10e-6))
    assert tr.device_ops()[0][0] == "Memcpy HtoD (Pinned -> Device)"
    assert tr.device_ops()[1][0] == "fused_infer_kernel<false>"
    gaps = dict(tr.idle_gaps())
    assert gaps["cudaEventSynchronize (1 gaps)"] == pytest.approx(20e-6)
    assert gaps["portbench.outer (2 gaps)"] == pytest.approx(50e-6)   # [0, 10) and [60, 100)
    rec = _rec(trace=tr, traced_calls=[np.arange(4)])
    assert readers.device_idle_pct(rec) == pytest.approx(70.0)


def test_roofline_and_mfu_arithmetic():
    cfg = json.loads((ROOT / "portbench/configs/convcotm-fmnist.json").read_text())
    card = {"hbm_bytes_per_s": 3.35e12, "int_ops_per_s": 1e13}
    tr = TraceData(start_us=0.0, end_us=1e6,
                   device=[("fused_infer_kernel<false>", 0, 20), ("ingress_pack_kernel", 30, 40)],
                   host=[])
    tests = np.full(4096, 1000, np.int64)
    rec = _rec(trace=tr, traced_calls=[np.arange(256)], card=card, cfg=cfg,
               facts={"word_tests": tests}, window_pool_idx=np.arange(4096), window_s=2.0)
    b_fused = 4 * 256 * 361 * 9 + 4 * 128 * 9 + 128 + 10 * 128 + 4 * 256 * 10
    bound = max(b_fused / 3.35e12, 256 * 1000 / 1e13)
    assert readers.fused_infer_roofline_pct(rec) == pytest.approx(100 * bound / 20e-6)
    b_ing = 256 * 784 + 4 * 256 * 361 * 9
    assert readers.ingress_pack_roofline_pct(rec) == pytest.approx(
        100 * max(b_ing / 3.35e12, 256 * 361 * 9 / 1e13) / 10e-6)
    assert readers.classify_mfu_pct(rec) == pytest.approx(100 * 4096 * 1000 / (2.0 * 1e13))
    assert readers.fused_infer_roofline_pct(_rec(trace=tr, traced_calls=[])) is None


def test_end_to_end_readers():
    assert reader(ROOT, "cls_per_s")(_rec(images_in_window=1000, window_s=2.0)) == 500.0
    assert reader(ROOT, "service.images_per_batch")(
        _rec(service_images=30, service_batches=4)) == 7.5
    assert reader(ROOT, "engine.host_ms_per_call")(
        _rec(dispatch_s=np.array([0.001, 0.003]))) == pytest.approx(2.0)


@pytest.mark.card
def test_cells_on_the_card():
    """Each cell, briefly, on the card: correct, and its metrics read."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in load_benchmark(ROOT)["workloads"]:
        for trace in (False, True):
            out = run_cell(w["name"], 3, 1.0, trace, proc_start=time.perf_counter(),
                           log=lambda s: None)
            assert out["correct"] and out["device"]["platform"] == "gpu"
            assert out["metrics"]


def test_a_system_is_added_as_files(tmp_path):
    """A configuration of a system the harness has never seen runs from new
    files and entries alone: its module under ``systems/``, its generator,
    its traffic, its metric; a fact of its own, measured by the generator
    and another added by the judge, reaches the metric through
    ``rec.facts`` with no field of the harness's."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    (pb / "systems/echo.py").write_text(
        "from harness.cell import STREAM_POOL\n\n\n"
        "def make(cfg, streams, name, device):\n"
        "    pool = streams[STREAM_POOL].integers(0, 100, cfg['n'])\n"
        "    return (lambda x: x * cfg['factor']), pool, {'pool': pool}\n\n\n"
        "def judge(run, trace, log):\n"
        "    want = run.inputs['pool'] * run.cfg['factor']\n"
        "    bad = sum(int(got != want[i]) for i, got in run.outcome.answers)\n"
        "    return ({'bad': {'value': bad, 'limit': 0},\n"
        "             'answered': {'value': len(run.outcome.answers), 'min': 1}},\n"
        "            {'echo_judged': len(run.outcome.answers)})\n")
    (pb / "loads/echo_loop.py").write_text(
        "import time\n\nfrom harness.cell import Outcome\n\n\n"
        "def run(ctx, seconds, trace):\n"
        "    ctx.window_start = t0 = time.perf_counter()\n"
        "    answers = []\n"
        "    while not answers or time.perf_counter() < t0 + seconds:\n"
        "        i = int(ctx.rng.integers(0, len(ctx.pool)))\n"
        "        answers.append((i, ctx.engine(ctx.pool[i])))\n"
        "    return Outcome(attempted=len(answers), failed=0, missing=0, answers=answers,\n"
        "                   window_s=seconds, facts={'echo_sent': len(answers)})\n")
    (pb / "traffic/echo-1.json").write_text(json.dumps({"kind": "echo_loop"}))
    (pb / "configs/echo.json").write_text(json.dumps({"system": "echo", "n": 16, "factor": 3}))
    (pb / "metrics/echo_per_s.py").write_text(
        "def read(rec):\n"
        "    assert rec.facts['echo_judged'] == rec.facts['echo_sent'] == len(rec.answers)\n"
        "    return rec.facts['echo_sent'] / rec.window_s\n")
    b = load_benchmark(ROOT)
    b["configs"].append({"name": "echo", "source": "test", "file": "portbench/configs/echo.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "echo-cell", "config": "echo", "traffic": "echo-1",
                           "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "echo_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": ["echo-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    e2e, layer = cell_metrics(b, "echo-cell")
    assert {m["name"] for m in e2e} == {"echo_per_s", "setup_s"} and not layer
    out = run_cell("echo-cell", 2**40 + 3, 0.05, False, proc_start=time.perf_counter(),
                   device="cpu", root=root, log=lambda s: None)
    assert out["correct"] and out["checks"]["bad"]["value"] == 0
    assert out["metrics"]["echo_per_s"]["value"] > 0
    assert "echo_per_s" not in {m["name"] for m in cell_metrics(b, "fmnist-bulk")[0]}
