"""Port vs reference: the train -> shadow -> promote lifecycle driver.

Both drivers train one round from the same model on the same data; the
port's trainer takes the reference's own ``jax.random`` draws
(``chain_draws`` of ``tests/test_torch_tm_engine.py``), so both rounds
shadow the same candidate arrays against the same live model.  The
reports, the promote-or-reject decision, the installed version and the
promoted checkpoint must be equal.  A round under open-loop load through
the port's service keeps every result equal to the reference engine's
classify on the version it names.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.checkpointer import restore_servable as j_restore_servable
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import CoTMModel as JCoTMModel
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.core.patches import PatchSpec as JPatchSpec
from repro.launch.lifecycle import LifecycleConfig as JLifecycleConfig
from repro.launch.lifecycle import LifecycleDriver as JLifecycleDriver
from repro.launch.lifecycle import ShadowReport as JShadowReport
from repro.serve import ServingEngine as JServingEngine
from repro.train.tm_engine import TrainerEngine as JTrainerEngine
from repro_torch.checkpoint.checkpointer import restore_servable
from repro_torch.configs.convcotm import COTM_CONFIGS
from repro_torch.convert import model_from_arrays, model_to_arrays
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.patches import PatchSpec
from repro_torch.launch import lifecycle as tlife
from repro_torch.launch.lifecycle import LifecycleConfig, LifecycleDriver, ShadowReport
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.loadgen import poisson_open_loop
from repro_torch.serve.service import ServiceConfig, ServingService
from repro_torch.train.tm_engine import TrainerEngine
from test_torch_tm_engine import chain_draws

PATCH = dict(image_x=8, image_y=8, window_x=3, window_y=3)
KW = dict(n_clauses=16, n_classes=3, T=15, s=3.0)
JCFG = JCoTMConfig(patch=JPatchSpec(**PATCH), **KW)
TCFG = CoTMConfig(patch=PatchSpec(**PATCH), **KW)
B = 16


def _data(seed=0):
    rng = np.random.default_rng(seed)
    tx = (rng.random((64, 8, 8)) > 0.5).astype(np.uint8)
    ty = rng.integers(0, 3, 64).astype(np.int32)
    vx = (rng.random((32, 8, 8)) > 0.5).astype(np.uint8)
    vy = rng.integers(0, 3, 32).astype(np.int32)
    return tx, ty, vx, vy


def _rounds(tmp_path, config_kw):
    """One lifecycle round on each package from the same live model, data
    and draws; returns (reference driver, report), (port driver, report)."""
    tx, ty, vx, vy = _data()
    key = jax.random.PRNGKey(1)
    jm0 = j_init_boundary(jax.random.PRNGKey(0), JCFG)
    tm0 = model_from_arrays(jm0.ta_state, jm0.weights)   # before jm0 is donated
    jtrainer = JTrainerEngine(JCFG, batch_size=B)
    jengine = JServingEngine(max_batch=16)
    jengine.register("m", jtrainer.freeze_servable(jm0), booleanize_method="none")
    jdriver = JLifecycleDriver(jtrainer, jengine, "m", config=JLifecycleConfig(**config_kw),
                               ckpt_dir=str(tmp_path / "ref"), booleanize_method="none")
    _, jm, _, jrep = jdriver.run_round(key, jm0, jtrainer.prepare(tx, ty, booleanize_method="none"),
                                       vx, vy, epochs=1)

    trainer = TrainerEngine(TCFG, batch_size=B, device="cpu")
    engine = ServingEngine(max_batch=16, device="cpu")
    engine.register("m", trainer.freeze_servable(tm0), booleanize_method="none")
    driver = LifecycleDriver(trainer, engine, "m", config=LifecycleConfig(**config_kw),
                             ckpt_dir=str(tmp_path / "port"), booleanize_method="none")
    _, draws = chain_draws(key, len(tx) // B, B, JCFG)
    source, tm, state, rep = driver.run_round(
        iter(draws), tm0, trainer.prepare(tx, ty, booleanize_method="none"), vx, vy,
        epochs=1)
    assert next(source, None) is None
    ta, w = model_to_arrays(tm)
    np.testing.assert_array_equal(ta, np.asarray(jm.ta_state))
    np.testing.assert_array_equal(w, np.asarray(jm.weights))
    assert state.epoch == 1
    return (jdriver, jrep), (driver, rep)


@pytest.mark.parametrize("config_kw", [
    dict(min_agreement=0.0, allow_accuracy_drop=1.0, shadow_requests=32),
    dict(min_agreement=1.0, shadow_requests=24),
], ids=["promote", "reject"])
def test_round_decides_as_the_reference(tmp_path, config_kw):
    (jdriver, jrep), (driver, rep) = _rounds(tmp_path, config_kw)
    assert rep.as_dict() == jrep.as_dict()
    assert rep.promoted == (config_kw["min_agreement"] == 0.0)
    assert rep.candidate_digest and rep.live_version == 1
    eng, jeng = driver.engine, jdriver.engine
    assert eng.models() == jeng.models() == ("m", "m@shadow")
    for slot in ("m", "m@shadow"):
        assert eng.version(slot).as_dict() == jeng.version(slot).as_dict()
    if rep.promoted:
        assert rep.promoted_version == 2
        got, step = restore_servable(TCFG, str(tmp_path / "port"), device="cpu")
        want, jstep = j_restore_servable(JCFG, str(tmp_path / "ref"))
        assert step == jstep == 2
        assert got.version.as_dict() == want.version.as_dict()
        assert got.version.digest == driver.engine.version("m").digest
        assert driver.rollback().as_dict() == jdriver.rollback().as_dict()
    else:
        assert "agreement" in rep.reason and rep.promoted_version is None
        assert not (tmp_path / "port").exists()


def test_config_refusals_and_gate_match_reference():
    # autotune_candidate is accepted, as the reference accepts it.
    assert dataclasses.asdict(LifecycleConfig(autotune_candidate=True)) == dataclasses.asdict(
        JLifecycleConfig(autotune_candidate=True))
    for kw, match in ((dict(min_agreement=1.5), "min_agreement"),
                      (dict(allow_accuracy_drop=-1), "allow_accuracy_drop"),
                      (dict(shadow_requests=0), "shadow_requests")):
        with pytest.raises(ValueError, match=match):
            LifecycleConfig(**kw)
    cfg = dict(min_agreement=0.9, allow_accuracy_drop=0.0)
    driver = LifecycleDriver(None, None, "m", config=LifecycleConfig(**cfg))
    jdriver = JLifecycleDriver(None, None, "m", config=JLifecycleConfig(**cfg))
    for kw in (dict(agreement=0.5), dict(agreement=1.0, live_accuracy=0.8,
                                         candidate_accuracy=0.6),
               dict(agreement=0.95, live_accuracy=0.5, candidate_accuracy=0.5)):
        base = dict(n=8, live_version=1, candidate_digest="")
        assert driver.gate(ShadowReport(**base, **kw)) == \
            jdriver.gate(JShadowReport(**base, **kw))


def test_round_under_service_load_keeps_every_result_on_its_version(tmp_path):
    """The round (train, shadow, swap) runs off the event loop while a
    Poisson stream flows through the port's service: nothing is dropped,
    ids never go back, and each result equals the reference engine's
    classify on the version it names; then an instant rollback."""
    tx, ty, vx, vy = _data(seed=2)
    rng = np.random.default_rng(0)
    requests = [vx[rng.integers(0, 32, int(rng.integers(1, 4)))] for _ in range(30)]
    trainer = TrainerEngine(TCFG, batch_size=B, device="cpu")
    engine = ServingEngine(max_batch=16, device="cpu")
    jm0 = j_init_boundary(jax.random.PRNGKey(0), JCFG)
    tm0 = model_from_arrays(jm0.ta_state, jm0.weights)
    initial = trainer.freeze_servable(tm0)
    engine.register("m", initial, booleanize_method="none")
    service = ServingService(engine, ServiceConfig(max_delay_us=300.0))
    driver = LifecycleDriver(trainer, engine, "m",
                             config=LifecycleConfig(min_agreement=0.0, allow_accuracy_drop=1.0,
                                                    shadow_requests=32),
                             ckpt_dir=str(tmp_path), booleanize_method="none")
    _, draws = chain_draws(jax.random.PRNGKey(1), len(tx) // B, B, JCFG)

    async def run():
        await service.start()
        load = asyncio.create_task(poisson_open_loop(service, "m", requests, rate=60.0,
                                                     seed=3))
        _, model, _, report = await asyncio.to_thread(
            driver.run_round, iter(draws), tm0, trainer.prepare(tx, ty, booleanize_method="none"),
            vx, vy, epochs=1)
        admitted, rejected = await load
        results = await asyncio.gather(*(f for _, f in admitted))
        await service.stop(drain=True)
        return model, report, admitted, rejected, results

    model, report, admitted, rejected, results = asyncio.run(run())
    assert report.promoted and report.promoted_version == 2 and engine.version_id("m") == 2
    assert rejected == 0 and len(admitted) == len(requests)
    refs = {}
    for v, m in ((1, jm0), (2, model)):
        ta, w = (np.asarray(m.ta_state), np.asarray(m.weights)) if v == 1 else \
            model_to_arrays(m)
        ref = JServingEngine(max_batch=16)
        ref.register("m", JCoTMModel(ta_state=jnp.asarray(ta), weights=jnp.asarray(w)),
                     JCFG, booleanize_method="none")
        refs[v] = ref
    versions = []
    for (i, _), res in zip(admitted, results):
        versions.append(res.version)
        want = refs[res.version].classify("m", requests[i])
        np.testing.assert_array_equal(res.predictions, want.predictions)
        np.testing.assert_array_equal(res.class_sums, want.class_sums)
    assert versions == sorted(versions)
    stamp = driver.rollback()
    assert stamp.version == 3 and stamp.digest == initial.version.digest
    np.testing.assert_array_equal(engine.classify("m", vx).class_sums,
                                  refs[1].classify("m", vx).class_sums)


def test_cli_round_trip_on_cpu(tmp_path, capsys):
    tlife.main(["--arch", "convcotm-mnist", "--rounds", "2", "--epochs", "1", "--n-train",
                "100", "--batch-size", "50", "--shadow-requests", "32", "--agreement",
                "0.0", "--max-batch", "32", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "live v1" in out and "PROMOTED as v2" in out and "PROMOTED as v3" in out
    got, step = restore_servable(COTM_CONFIGS["convcotm-mnist"], str(tmp_path),
                                 device="cpu")
    assert step == 3 and got.version.version == 3
