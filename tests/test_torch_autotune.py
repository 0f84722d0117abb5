"""Port vs reference: the per-bucket autotuner, its plans and their lifecycle.

At the reference's autotune geometry (8x8 images, 4x4 windows, 16
clauses, 4 classes) the same numpy models and requests go through both
packages: the plans' JSON is byte for byte the reference's, the candidate
sets on the CPU are the reference's, every candidate (with the CUDA
kernels' parameter sets swept, which on the CPU take the plain versions)
gives the reference's class sums, and a tuned engine classifies as the
reference's engine does.  The port runs with ``device="cpu"``.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import CoTMModel as JCoTMModel
from repro.core.patches import PatchSpec as JPatchSpec
from repro.serve import ServingEngine as JServingEngine
from repro.serve import analyze_sparsity as j_analyze
from repro.serve import freeze as jfreeze
from repro.serve import paths as jpaths
from repro.serve.autotune import TunedPlan as JTunedPlan
from repro.serve.autotune import _candidates as j_candidates
from repro.serve.servable import servable_digest as j_digest
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.configs.convcotm import COTM_CONFIGS
from repro_torch.convert import model_from_arrays
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.patches import PatchSpec
from repro_torch.launch import lifecycle as tlife
from repro_torch.launch import serve as tserve
from repro_torch.serve import autotune as tat
from repro_torch.serve import paths as tpaths
from repro_torch.serve.autotune import TunedPlan, clear_measure_memo, plan_applies
from repro_torch.serve.engine import ServingEngine, classify_raw_step, classify_step
from repro_torch.serve.servable import analyze_sparsity, freeze
from test_torch_lifecycle import _rounds

PATCH = dict(image_x=8, image_y=8, window_x=4, window_y=4)
JCFG = JCoTMConfig(n_clauses=16, n_classes=4, patch=JPatchSpec(**PATCH))
TCFG = CoTMConfig(n_clauses=16, n_classes=4, patch=PatchSpec(**PATCH))
BUCKETS = (1, 8)
PATHS = ("bitpacked", "dense", "fused", "fused_sparse", "kernel", "matmul",
         "matmul_sparse", "sparse")
#: A plan a port engine on a card could hold.
PLAN = (TunedPlan()
        .with_entry("raw", 1, "fused", ())
        .with_entry("raw", 16, "fused_sparse", (("block_c", 64), ("csrf", False)))
        .with_entry("literals", 256, "kernel", (("block_c", 32),)))


def _pair(seed=0, per_clause=3.0, empty=0.3):
    """A reference model with a few includes per clause (clauses fire) and
    ~``empty`` of its clauses empty, and its port copy."""
    rng = np.random.default_rng(seed)
    n_lit = JCFG.n_literals
    ta = np.where(rng.random((16, n_lit)) < per_clause / n_lit, 133, 123).astype(np.uint8)
    ta[rng.random(16) < empty] = 0
    w = rng.integers(-20, 21, (4, 16)).astype(np.int32)
    return JCoTMModel(ta_state=jnp.asarray(ta), weights=jnp.asarray(w)), model_from_arrays(ta, w)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 8, 8), dtype=np.uint8)


def _tuned_engine(seed=0, **kw):
    eng = ServingEngine(max_batch=max(BUCKETS), device="cpu", autotune=True,
                        autotune_repeats=1, **kw)
    eng.register("m", _pair(seed)[1], TCFG, path="fused")
    eng.autotune("m", buckets=BUCKETS)
    return eng


# --- TunedPlan --------------------------------------------------------------

def _both(plan):
    """The port's plan and the reference's with the same entries and digest."""
    return plan, JTunedPlan(entries=plan.entries, digest=plan.digest)


@pytest.mark.parametrize("form,bucket", [("raw", 1), ("raw", 8), ("raw", 16), ("raw", 512),
                                         ("literals", 4), ("literals", 256),
                                         ("literals", 1024), ("host", 1)])
def test_lookup_matches_reference(form, bucket):
    port, ref = _both(PLAN)
    assert port.lookup(form, bucket) == ref.lookup(form, bucket)


def test_lookup_rules():
    assert PLAN.lookup("raw", 16) == ("fused_sparse", (("block_c", 64), ("csrf", False)))
    assert PLAN.lookup("raw", 8) == ("fused", ())                 # nearest below
    assert PLAN.lookup("literals", 2) == ("kernel", (("block_c", 32),))   # smallest above
    assert PLAN.lookup("preprocessed", 4) is None


def test_with_entry_replaces_and_keeps_the_digest():
    plan = PLAN.with_entry("raw", 16, "dense", ())
    ref = JTunedPlan(entries=PLAN.entries).with_entry("raw", 16, "dense", ())
    assert plan.entries == ref.entries and len(plan.entries) == len(PLAN.entries)
    stamped = TunedPlan(digest="abc").with_entry("raw", 1, "fused", ())
    assert stamped.digest == "abc"


@pytest.mark.parametrize("digest", ["", "0123456789ab"], ids=["unstamped", "stamped"])
def test_json_is_the_references_byte_for_byte(digest):
    port, ref = _both(TunedPlan(entries=PLAN.entries, digest=digest))
    assert port.to_json() == ref.to_json()
    assert TunedPlan.from_json(ref.to_json()) == port
    back = JTunedPlan.from_json(port.to_json())
    assert back.entries == port.entries and back.digest == digest


def test_json_round_trip_gives_bools_and_tuples():
    back = TunedPlan.from_json(PLAN.to_json())
    assert back == PLAN and hash(back) == hash(PLAN)
    params = back.lookup("raw", 16)[1]
    assert isinstance(params, tuple) and params[1][1] is False
    assert hash(PLAN) == hash(TunedPlan(entries=PLAN.entries))


def test_plan_applies_only_to_registered_paths_and_their_params():
    assert plan_applies(PLAN) and plan_applies(TunedPlan())
    for entry in (("raw", 1, "fused", (("block_b", 16),)),     # a reference TPU param
                  ("raw", 1, "nope", ()),
                  ("raw", 1, "dense", (("csrf", False),))):     # dense has no params
        assert not plan_applies(PLAN.with_entry(*entry))


# --- candidates ---------------------------------------------------------------

@pytest.mark.parametrize("sparsity", [True, False], ids=["sparsity", "no_sparsity"])
@pytest.mark.parametrize("form", ["literals", "raw"])
@pytest.mark.parametrize("registered", PATHS)
def test_cpu_candidates_match_reference(registered, form, sparsity):
    """On a CPU both packages time the defaults only, over the same paths."""
    jm, tm = _pair()
    js, ts = jfreeze(jm, JCFG), freeze(tm, TCFG)
    if sparsity:
        js, ts = j_analyze(js), analyze_sparsity(ts)
    sweep = tat._sweeps_params(torch.device("cpu"))
    assert sweep is (jax.default_backend() == "tpu") is False
    want = j_candidates(js, jpaths.get_path(registered), form, sweep_params=sweep)
    got = tat._candidates(ts, tpaths.get_path(registered), form, sweep_params=sweep)
    assert got == want


@pytest.mark.parametrize("form", ["literals", "raw"])
def test_swept_candidates_equal_the_references_dense_path(monkeypatch, form):
    """With the sweep on, every kernel path competes at every parameter set
    of ``_KERNEL_TUNABLE``; each candidate's class sums and predictions
    equal the reference engine's on the dense path."""
    monkeypatch.setattr(tat, "_sweeps_params", lambda device: True)
    jm, tm = _pair()
    eng = ServingEngine(max_batch=8, device="cpu")
    ts = eng.register("m", tm, TCFG, path="fused")
    cands = tat._candidates(ts, tpaths.get_path("fused"), form, sweep_params=True)
    swept = {(n, p) for n in ("kernel", "fused", "sparse", "fused_sparse")
             for p in tpaths._KERNEL_TUNABLE}
    assert swept <= set(cands) and cands == sorted(cands)
    assert {n for n, _ in cands} == (set(PATHS) if form == "raw" else
                                     {"bitpacked", "kernel", "fused", "sparse", "fused_sparse"})
    imgs = _images(8, seed=3)
    jeng = JServingEngine(max_batch=8)
    jeng.register("m", jm, JCFG, path="dense")
    want = jeng.classify("m", imgs)
    assert want.class_sums.any()
    x = (torch.from_numpy(imgs) if form == "raw"
         else torch.from_numpy(eng.preprocess("m", imgs).view(np.int32)))
    for name, params in cands:
        out = (classify_raw_step(ts, x, name, eng.ingress_spec("m"), params) if form == "raw"
               else classify_step(ts, x, name, params)).numpy()
        np.testing.assert_array_equal(out[:, 1:], want.class_sums, err_msg=f"{name} {params}")
        np.testing.assert_array_equal(out[:, 0], want.predictions, err_msg=f"{name} {params}")


def test_swept_plan_serves_as_the_reference(monkeypatch):
    monkeypatch.setattr(tat, "_sweeps_params", lambda device: True)
    clear_measure_memo()
    try:
        eng = _tuned_engine()
    finally:
        clear_measure_memo()     # do not leave swept timings for other tests
    rows = eng.stats("m").autotune["rows"]
    assert all(len(r["candidates"]) >= 21 for r in rows)
    jeng = JServingEngine(max_batch=8)
    jeng.register("m", _pair()[0], JCFG, path="fused")
    for n in (1, 5, 8):
        imgs = _images(n, seed=n)
        got, want = eng.classify("m", imgs), jeng.classify("m", imgs)
        np.testing.assert_array_equal(got.class_sums, want.class_sums)


# --- the tuned engine ---------------------------------------------------------

@pytest.mark.parametrize("ingress", ["device", "host"], ids=["raw", "literals"])
def test_tuned_engine_equals_reference(ingress):
    """Whatever wins each (form, bucket), results equal the reference
    engine's: tuning never changes an output."""
    eng = _tuned_engine()
    eng.warmup("m", buckets=BUCKETS)
    jeng = JServingEngine(max_batch=8)
    jeng.register("m", _pair()[0], JCFG, path="fused")
    for n in (1, 3, 8):
        imgs = _images(n, seed=n)
        got, want = eng.classify("m", imgs, ingress=ingress), jeng.classify("m", imgs)
        np.testing.assert_array_equal(got.class_sums, want.class_sums)
        np.testing.assert_array_equal(got.predictions, want.predictions)
        lits = eng.preprocess("m", imgs)
        np.testing.assert_array_equal(eng.classify("m", lits, preprocessed=True).class_sums,
                                      want.class_sums)


def test_dispatch_runs_the_tuned_path(monkeypatch):
    eng = _tuned_engine()
    pinned = TunedPlan().with_entry("raw", 1, "dense", ()).with_entry("raw", 8, "matmul", ())
    eng.swap("m", _pair()[1], TCFG, tuned=pinned)
    ran = []
    run = tpaths.run_path

    def record(path, *a, **k):
        ran.append(path.name)
        return run(path, *a, **k)

    # The literal step calls the engine's run_path, the raw step the paths'.
    monkeypatch.setattr("repro_torch.serve.engine.run_path", record)
    monkeypatch.setattr("repro_torch.serve.paths.run_path", record)
    eng.classify("m", _images(1))
    eng.classify("m", _images(6))
    eng.classify("m", eng.preprocess("m", _images(2)), preprocessed=True)
    assert ran == ["dense", "matmul", "fused"]      # literals untuned: the registered path


class TestDeterminismAndBudget:
    def test_two_registrations_same_plan(self):
        a, b = _tuned_engine(), _tuned_engine()
        assert a.servable("m").tuned == b.servable("m").tuned
        assert a.servable("m").tuned.entries

    def test_plan_covers_requested_cells_and_is_stamped(self):
        eng = _tuned_engine()
        plan = eng.servable("m").tuned
        assert {(f, b) for f, b, _, _ in plan.entries} == {
            ("literals", 1), ("literals", 8), ("raw", 1), ("raw", 8)}
        assert plan.digest == eng.version("m").digest == j_digest(jfreeze(_pair()[0], JCFG))
        st = eng.stats("m").autotune
        assert set(st) == {"rows", "total_s", "plan"}
        assert st["plan"] == [list(e) for e in plan.entries]

    def test_pretuned_plan_skips_remeasure(self):
        plan = _tuned_engine().servable("m").tuned
        eng = ServingEngine(max_batch=8, device="cpu", autotune=True)
        eng.register("m", _pair()[1], TCFG, path="fused", tuned=TunedPlan.from_json(plan.to_json()))
        eng.warmup("m", buckets=BUCKETS)
        assert eng.servable("m").tuned == plan
        assert eng.stats("m").autotune == {}

    def test_cold_sweep_is_bounded(self):
        clear_measure_memo()
        t0 = time.perf_counter()
        eng = _tuned_engine()
        elapsed = time.perf_counter() - t0
        assert eng.stats("m").autotune["total_s"] <= elapsed < 60.0

    def test_max_seconds_skips_but_still_plans(self):
        clear_measure_memo()
        eng = ServingEngine(max_batch=8, device="cpu", autotune=True, autotune_repeats=1,
                            autotune_max_seconds=0.0)
        eng.register("m", _pair()[1], TCFG, path="fused")
        eng.autotune("m", buckets=BUCKETS)
        cells = {(f, b) for f, b, _, _ in eng.servable("m").tuned.entries}
        assert {("literals", 1), ("raw", 8)} <= cells
        assert any(r["skipped"] for r in eng.stats("m").autotune["rows"])
        clear_measure_memo()


def test_sweep_runs_outside_the_engine_lock(monkeypatch):
    """A dispatch thread can take the engine lock while a candidate is
    being timed: the sweep does not stall a running service."""
    eng = ServingEngine(max_batch=8, device="cpu", autotune=True, autotune_repeats=1)
    eng.register("m", _pair()[1], TCFG, path="fused")
    free = []
    measure = tat._measure

    def take_lock():
        got = eng.swap_guard().acquire(timeout=5)
        if got:
            eng.swap_guard().release()
        free.append(got)

    def probe(*a, **k):
        t = threading.Thread(target=take_lock)
        t.start()
        t.join(10)
        assert not t.is_alive()
        return measure(*a, **k)

    monkeypatch.setattr(tat, "_measure", probe)
    clear_measure_memo()
    eng.warmup("m", buckets=(1,))
    clear_measure_memo()
    assert free and all(free)
    assert eng.servable("m").tuned is not None


# --- lifecycle and checkpoints ------------------------------------------------

def test_swap_retune_rollback_and_degrade():
    eng = _tuned_engine()
    first = eng.servable("m").tuned
    jm2, tm2 = _pair(seed=5)
    carried = eng.swap("m", tm2, TCFG)
    assert eng.servable("m").tuned == first and first.digest != carried.digest
    stamp = eng.swap("m", tm2, TCFG, retune=True)
    plan = eng.servable("m").tuned
    assert plan.digest == stamp.digest == j_digest(jfreeze(jm2, JCFG))
    assert eng.stats("m").autotune["plan"] == [list(e) for e in plan.entries]
    eng.swap("m", tm2, TCFG, tuned=PLAN)
    assert eng.servable("m").tuned == PLAN
    eng.rollback("m")
    assert eng.servable("m").tuned == plan       # the displaced image, with its plan
    eng.rollback("m")
    assert eng.servable("m").tuned == PLAN
    eng.degrade_path("m")
    assert eng.servable("m").tuned is None


def test_lifecycle_round_with_autotune_candidate_decides_as_the_reference(tmp_path):
    """Fed the reference's draws, the port's round with the candidate tuned
    while shadowing makes the reference's decision, and promotes the
    candidate with the plan measured on the shadow slot."""
    cfg = dict(min_agreement=0.0, allow_accuracy_drop=1.0, shadow_requests=32,
               autotune_candidate=True)
    (jdriver, jrep), (driver, rep) = _rounds(tmp_path, cfg)
    assert rep.as_dict() == jrep.as_dict() and rep.promoted
    shadow = driver.engine.servable(tlife.shadow_slot("m")).tuned
    live = driver.engine.servable("m").tuned
    assert live == shadow and live.digest == rep.candidate_digest
    assert live.digest == jdriver.engine.servable("m").tuned.digest
    assert tlife.LifecycleConfig(autotune_candidate=True).autotune_candidate


def _save_reference_servable(directory, plan):
    jm, _ = _pair()
    js = jfreeze(jm, JCFG)
    jck.save_servable(dataclasses.replace(js, tuned=plan), str(directory), 1)


@pytest.mark.parametrize("case", ["reference", "other_device", "unknown_path", "malformed",
                                  "trainer_reference"])
def test_foreign_plans_restore_as_none_and_are_retuned(tmp_path, case):
    """No device stamp (every plan the JAX package writes), another device's
    stamp, an entry this package cannot dispatch, or a malformed plan: the
    plan restores as None, and an armed engine re-tunes at warmup."""
    _, tm = _pair()
    if case == "reference":
        _save_reference_servable(tmp_path, JTunedPlan(
            entries=(("raw", 1, "fused", (("block_b", 16),)),), digest="x"))
    elif case == "trainer_reference":
        jck.save_pytree(_pair()[0], str(tmp_path), 1, extra={
            "tuned_plan": JTunedPlan(entries=(("raw", 1, "fused", ()),)).to_json()})
    else:
        ts = freeze(tm, TCFG).replace(tuned=PLAN)
        tck.save_servable(ts, str(tmp_path), 1)
        manifest = tmp_path / "step_00000001" / "manifest.json"
        doc = json.loads(manifest.read_text())
        assert doc["extra"]["tuned_plan_device"] == "cpu"
        if case == "other_device":
            doc["extra"]["tuned_plan_device"] = "NVIDIA H100 80GB HBM3"
        elif case == "unknown_path":
            doc["extra"]["tuned_plan"] = PLAN.with_entry("raw", 1, "gone", ()).to_json()
        else:
            doc["extra"]["tuned_plan"] = '{"entries": [{"form": "raw"}]}'
        manifest.write_text(json.dumps(doc))
    if case != "trainer_reference":
        assert tck.restore_servable(TCFG, str(tmp_path), device="cpu")[0].tuned is None
    eng = ServingEngine(max_batch=8, device="cpu", autotune=True, autotune_repeats=1)
    eng.load_checkpoint("m", str(tmp_path), TCFG, path="fused")
    assert eng.servable("m").tuned is None
    eng.warmup("m", buckets=(1,))
    plan = eng.servable("m").tuned
    assert eng.stats("m").autotune and plan.digest == eng.version("m").digest
    assert plan_applies(plan)


def test_port_plan_round_trips_through_checkpoints(tmp_path):
    eng = _tuned_engine()
    plan = eng.servable("m").tuned
    tck.save_servable(eng.servable("m"), str(tmp_path), 2)
    back, _ = tck.restore_servable(TCFG, str(tmp_path), device="cpu")
    assert back.tuned == plan
    js, _ = jck.restore_servable(JCFG, str(tmp_path))
    assert js.tuned.entries == plan.entries and js.tuned.digest == plan.digest
    armed = ServingEngine(max_batch=8, device="cpu", autotune=True)
    armed.load_checkpoint("m", str(tmp_path), TCFG, path="fused")
    armed.warmup("m", buckets=BUCKETS)
    assert armed.servable("m").tuned == plan and armed.stats("m").autotune == {}


# --- launchers ------------------------------------------------------------------

def test_serve_launcher_autotunes_on_cpu(capsys):
    tserve.main(["--arch", "convcotm-mnist", "--requests", "2", "--max-batch", "2",
                 "--autotune", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "convcotm-mnist: autotuned in " in out and "plan [['literals', 1" in out
    assert json.loads(out.strip().splitlines()[-1])["autotune"]["plan"]


def test_lifecycle_launcher_autotunes_on_cpu(tmp_path, capsys):
    tlife.main(["--arch", "convcotm-mnist", "--rounds", "1", "--epochs", "1", "--n-train",
                "50", "--batch-size", "50", "--shadow-requests", "8", "--agreement", "0.0",
                "--max-batch", "2", "--ckpt-dir", str(tmp_path), "--autotune",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "PROMOTED as v2" in out and "candidate autotuned in " in out
    got, _ = tck.restore_servable(COTM_CONFIGS["convcotm-mnist"], str(tmp_path),
                                  device="cpu")
    assert got.tuned is not None and got.tuned.digest == got.version.digest
