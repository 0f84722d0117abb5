"""Port vs reference: the async serving service over the port's engine.

``ServingService`` and its scheduler, fault plan and load generator are
copies of the reference's modules running on the port's ``ServingEngine``
(``device="cpu"``, the kernels' plain versions).  Every result a service
returns is held bit for bit against the reference engine's ``classify``
of the same images on the version that computed it: under concurrent
submitters, mixed request forms, a graceful drain, a swap storm, the
circuit breaker and quarantine.  The chaos soak must leave no future
hung.  Small geometry: 11x11 images, 5x5 windows, C=37.
"""

import asyncio
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import CoTMModel as JCoTMModel
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.core.patches import PatchSpec as JPatchSpec
from repro.serve import ServiceConfig as JServiceConfig
from repro.serve import ServingEngine as JServingEngine
from repro.serve import ServingService as JServingService
from repro.serve import scheduler as jsched
from repro.serve.loadgen import poisson_open_loop as j_poisson_open_loop
from repro_torch.checkpoint.checkpointer import save_servable
from repro_torch.configs.convcotm import COTM_CONFIGS
from repro_torch.convert import model_from_arrays
from repro_torch.core.cotm import CoTMConfig, init_boundary_model
from repro_torch.core.patches import PatchSpec
from repro_torch.core.prng import prng_key
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.faults import (
    DegradationPolicy,
    FaultPlan,
    InjectedEngineError,
    PoisonedPayload,
    ServiceExpired,
    chaos_soak,
)
from repro_torch.serve.loadgen import poisson_open_loop
from repro_torch.serve.servable import freeze
from repro_torch.serve.service import ServiceConfig, ServiceOverloaded, ServingService

EDGE = dict(image_x=11, image_y=11, window_x=5, window_y=5)
JCFG = JCoTMConfig(n_clauses=37, n_classes=10, patch=JPatchSpec(**EDGE))
TCFG = CoTMConfig(n_clauses=37, n_classes=10, patch=PatchSpec(**EDGE))


def _pool(seed=0):
    """A reference model with a few includes per clause (so clauses fire
    and class sums differ between seeds) and its port copy."""
    jm = j_init_boundary(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((37, JCFG.n_literals)) < 3.0 / JCFG.n_literals, 133,
                  123).astype(np.uint8)
    w = np.asarray(jm.weights) + rng.integers(-3, 4, (10, 37)).astype(np.int32)
    return (JCoTMModel(ta_state=jnp.asarray(ta), weights=jnp.asarray(w)),
            model_from_arrays(ta, w))


def _raw(n, seed):
    return np.random.default_rng(seed + 100).integers(0, 256, (n, 11, 11), dtype=np.uint8)


def _same(a, b):
    np.testing.assert_array_equal(a.predictions, b.predictions)
    np.testing.assert_array_equal(a.class_sums, b.class_sums)


def _pair(*, faults=None, path="fused", max_batch=16, seed=0):
    """The port's engine (with an optional fault plan) and the reference
    engine, serving the same model."""
    jm, tm = _pool(seed)
    engine = ServingEngine(max_batch=max_batch, device="cpu", faults=faults)
    engine.register("glyphs", tm, TCFG, path=path)
    ref = JServingEngine(max_batch=max_batch)
    ref.register("glyphs", jm, JCFG, path=path)
    return engine, ref


def _scheduler_trace(mod):
    """One scripted run of a scheduler module on a fake clock: what it
    admits, refuses, dispatches (and when), expires and drains."""
    s = mod.MicrobatchScheduler(mod.SchedulerConfig(max_delay_us=100.0, high_water=8),
                                max_coalesce=4)
    out = []

    def req(model, n, t, version=0, deadline=None):
        return mod.PendingRequest(model=model, literals=np.zeros((n, 1), np.uint8), n=n,
                                  enqueue_t=t, version=version, deadline_t=deadline)

    for model, n, t, v, d in [("a", 1, 0.0, 1, None), ("b", 2, 0.0, 1, None),
                              ("a", 2, 10e-6, 1, None), ("a", 1, 20e-6, 2, None),
                              ("b", 3, 30e-6, 1, 50e-6), ("a", 5, 40e-6, 2, None),
                              ("b", 9, 45e-6, 1, None)]:
        try:
            s.submit(req(model, n, t, v, d))
            out.append(("admit", model, s.depth(model)))
        except mod.QueueFull as e:
            out.append(("full", model, e.depth))
    for now in (0.0, 60e-6, 100e-6, 120e-6, 300e-6):
        out.append(("expired", now, [(r.model, r.n) for r in s.expire(now)]))
        while (m := s.next_ready(now)) is not None:
            out.append(("pop", now, m, [(r.n, r.version) for r in s.pop_batch(m)]))
        out.append(("deadline", s.earliest_deadline(), s.earliest_expiry()))
    out.append(("drain", [(r.model, r.n) for r in s.drain_all()], s.total_depth()))
    return out


def test_scheduler_copy_decides_as_the_reference():
    assert _scheduler_trace(tsched) == _scheduler_trace(jsched)


def test_results_match_reference_under_concurrent_mixed_forms_and_drain():
    """Concurrent raw, preprocessed and host-ingress submitters, then a
    queue that only stop(drain=True) flushes: every result equals the
    reference engine's classify of the same images."""
    engine, ref = _pair()
    sizes = [1, 3, 7, 2, 5, 1, 4, 6, 2, 1, 17, 3]
    batches = [_raw(n, seed=i) for i, n in enumerate(sizes)]

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=500.0))
        await service.start()

        async def one(i, b):
            await asyncio.sleep(0.0005 * (i % 3))       # vary the coalescing
            if i % 3 == 1:
                return await service.submit("glyphs", engine.preprocess("glyphs", b),
                                            preprocessed=True)
            if i % 3 == 2:
                return await service.submit("glyphs", b, host_ingress=True)
            return await service.submit("glyphs", b)

        results = await asyncio.gather(*(one(i, b) for i, b in enumerate(batches)))
        await service.stop(drain=True)
        held = ServingService(engine, ServiceConfig(max_delay_us=10e6))
        await held.start()
        futs = [held.submit_nowait("glyphs", b) for b in batches[:4]]
        await asyncio.sleep(0.01)
        assert not any(f.done() for f in futs)           # held by the window
        await held.stop(drain=True)
        return service, results, held, [f.result() for f in futs]

    service, results, held, drained = asyncio.run(run())
    for b, r in zip(batches, results):
        _same(r, ref.classify("glyphs", b))
        assert r.version == 1
    for b, r in zip(batches, drained):
        _same(r, ref.classify("glyphs", b))
    st = service.stats("glyphs")
    assert (st.completed, st.images) == (len(batches), sum(sizes))
    assert held.stats("glyphs").batches == 1 and drained[0].batch_requests == 4


def test_queue_wait_thread_times_and_collections_in_the_stats():
    """Each request's queue wait is at most its latency; the dispatch and
    completion threads' time per microbatch is counted; a collection
    forced while the service runs is counted and shows its pause, and the
    collector hook is gone after stop."""
    import gc

    engine, ref = _pair()
    batches = [_raw(n, seed=40 + i) for i, n in enumerate((1, 2, 5, 1, 3, 4))]

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=300.0))
        await service.start()
        hooks = [cb for cb in gc.callbacks if cb not in before]
        first = await asyncio.gather(*(service.submit("glyphs", b) for b in batches[:3]))
        counted = sum(service.stats("glyphs").gc_collections)
        gc.collect()
        after = service.stats("glyphs")
        rest = await asyncio.gather(*(service.submit("glyphs", b) for b in batches[3:]))
        await service.stop(drain=True)
        return service, hooks, first + rest, counted, after

    before = list(gc.callbacks)
    service, hooks, results, counted, after = asyncio.run(run())
    assert len(hooks) == 1 and gc.callbacks == before
    assert after.gc_collections[2] >= 1 and sum(after.gc_collections) > counted
    assert after.gc_max_gen2_pause_us > 0 and after.gc_pause_us[2] >= after.gc_max_gen2_pause_us
    for b, r in zip(batches, results):
        _same(r, ref.classify("glyphs", b))
        assert 0.0 <= r.queue_wait_s <= r.latency_s
    st = service.stats("glyphs")
    assert 0.0 < st.p50_queue_wait_us <= st.p99_queue_wait_us <= st.p99_latency_us
    assert st.dispatch_us_per_batch > 0 and st.complete_us_per_batch > 0
    assert st.as_dict()["gc_collections"] == st.gc_collections


def test_coalesced_microbatch_fills_one_bucket():
    engine, ref = _pair()

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=50_000.0))
        await service.start()
        out = await asyncio.gather(*[service.submit_nowait("glyphs", _raw(2, seed=i))
                                     for i in range(4)])
        await service.stop(drain=True)
        return service, out

    service, out = asyncio.run(run())
    assert all((r.batch_requests, r.batch_images, r.bucket) == (4, 8, 8) for r in out)
    for i, r in enumerate(out):
        _same(r, ref.classify("glyphs", _raw(2, seed=i)))
    st = service.stats("glyphs")
    assert st.occupancy_hist == {8: {"batches": 1, "images": 8}}
    assert st.mean_occupancy == 1.0 and engine.stats("glyphs").bucket_hits == {8: 1}


def test_backpressure_and_deadlines():
    """Past high water a submission is refused with a retry hint; a request
    still queued past its deadline is shed without reaching the engine."""
    plan = FaultPlan()
    engine, ref = _pair(faults=plan)

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=10e6, high_water=6))
        await service.start()
        admitted = [service.submit_nowait("glyphs", _raw(3, seed=i)) for i in range(2)]
        with pytest.raises(ServiceOverloaded) as e:
            service.submit_nowait("glyphs", _raw(1, seed=9))
        await service.stop(drain=True)
        late = ServingService(engine, ServiceConfig(max_delay_us=10e6))
        await late.start()
        fut = late.submit_nowait("glyphs", _raw(1, seed=3), deadline_s=0.005)
        with pytest.raises(ServiceExpired):
            await fut
        await late.stop(drain=True)
        return e.value, [f.result() for f in admitted], service

    err, admitted, service = asyncio.run(run())
    assert err.retry_after_s > 0 and service.stats("glyphs").rejected == 1
    for i, r in enumerate(admitted):
        _same(r, ref.classify("glyphs", _raw(3, seed=i)))
    assert plan.engine_dispatches == 1                   # the expired one never ran


def _storm(service, swap_models, requests, rollback_after):
    """Open-loop Poisson load with swaps landing while it runs, then one
    request after the last lifecycle event."""

    async def run():
        await service.start()
        load = asyncio.create_task(
            (poisson_open_loop if isinstance(service, ServingService)
             else j_poisson_open_loop)(service, "glyphs", requests, rate=600.0, seed=7))
        for i, m in enumerate(swap_models):
            await asyncio.sleep(0.012)
            await service.swap("glyphs", m, service.engine.servable("glyphs").config)
            if i == rollback_after:
                await asyncio.sleep(0.012)
                await service.rollback("glyphs")
        admitted, rejected = await load
        results = await asyncio.gather(*(f for _, f in admitted))
        final = await service.submit("glyphs", requests[0])
        await service.stop(drain=True)
        return admitted, rejected, results, final

    return asyncio.run(run())


def test_swap_storm_keeps_one_version_per_microbatch_as_the_reference():
    """The same storm on both services: nothing dropped, one version per
    microbatch, ids non-decreasing in admission order; each port result
    equals the reference engine's classify on the version it names."""
    pools = [_pool(seed=s) for s in range(4)]
    rng = np.random.default_rng(0)
    requests = [_raw(int(rng.integers(1, 5)), seed=1000 + i) for i in range(40)]
    # v1 = pool 0; swaps to pools 1, 2 (v2, v3); rollback (v4 = pool 1);
    # swap to pool 3 (v5).
    by_version = {1: 0, 2: 1, 3: 2, 4: 1, 5: 3}
    refs = {}
    for v, k in by_version.items():
        r = JServingEngine(max_batch=16)
        r.register("glyphs", pools[k][0], JCFG)
        refs[v] = r
    outcomes = {}
    for side in ("port", "reference"):
        if side == "port":
            engine = ServingEngine(max_batch=16, device="cpu")
            engine.register("glyphs", pools[0][1], TCFG)
            service = ServingService(engine, ServiceConfig(max_delay_us=200.0))
            swaps = [pools[k][1] for k in (1, 2, 3)]
        else:
            engine = JServingEngine(max_batch=16)
            engine.register("glyphs", pools[0][0], JCFG)
            service = JServingService(engine, JServiceConfig(max_delay_us=200.0))
            swaps = [pools[k][0] for k in (1, 2, 3)]
        outcomes[side] = _storm(service, swaps, requests, rollback_after=1)
    for side, (admitted, rejected, results, final) in outcomes.items():
        assert rejected == 0 and len(admitted) == len(requests), side
        by_batch = collections.defaultdict(set)
        versions = []
        for (i, _), res in zip(admitted, results):
            by_batch[res.batch_id].add(res.version)
            versions.append(res.version)
            if side == "port":
                _same(res, refs[res.version].classify("glyphs", requests[i]))
        assert all(len(vs) == 1 for vs in by_batch.values()), side
        assert versions == sorted(versions) and set(versions) <= set(by_version), side
        assert final.version == 5, side
        _same(final, refs[5].classify("glyphs", requests[0]))


def test_quarantine_fails_the_poisoned_member_alone():
    plan = FaultPlan()
    engine, ref = _pair(faults=plan)
    batches = [_raw(2, seed=i) for i in range(3)]
    plan.poison(batches[1])

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=30_000.0), faults=plan)
        await service.start()
        out = await asyncio.gather(*[service.submit_nowait("glyphs", b) for b in batches],
                                   return_exceptions=True)
        await service.stop(drain=True)
        return service, out

    service, out = asyncio.run(run())
    assert isinstance(out[1], PoisonedPayload) and out[1].model == "glyphs"
    for i in (0, 2):
        _same(out[i], ref.classify("glyphs", batches[i]))
    st = service.stats("glyphs")
    assert st.quarantined >= 1 and st.completed == 2


def test_breaker_steps_fused_to_matmul_and_stays_bit_identical():
    plan = FaultPlan(engine_error_at=(1, 2))
    engine, ref = _pair(faults=plan)
    imgs = _raw(3, seed=5)

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=100.0), faults=plan,
                                 policy=DegradationPolicy(failure_threshold=2))
        await service.start()
        errs = []
        for i in range(2):
            with pytest.raises(InjectedEngineError) as e:
                await service.submit("glyphs", _raw(1, seed=i))
            errs.append(e.value)
        res = await service.submit("glyphs", imgs)
        state = service.health().state
        await service.stop(drain=True)
        return service, errs, res, state

    service, errs, res, state = asyncio.run(run())
    assert len(errs) == 2 and state == "degraded"
    assert service.health().fallback_path == "matmul"
    assert engine.stats("glyphs").fallback_path == "matmul"
    assert engine.resolved_path("glyphs") == "matmul"
    ref.degrade_path("glyphs")
    _same(res, ref.classify("glyphs", imgs))


def test_real_dispatch_failure_degrades_health_but_keeps_the_path():
    """A failure that is not the chaos seam's (a kernel's error, an
    out-of-memory) fails its requests and marks the service degraded, but
    never moves the model off its path, however often it repeats."""
    engine, ref = _pair()
    real_dispatch = engine.dispatch
    calls = {"n": 0}

    def failing_dispatch(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise RuntimeError("kernel launch failed")
        return real_dispatch(*args, **kwargs)

    engine.dispatch = failing_dispatch
    imgs = _raw(3, seed=5)

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=100.0),
                                 policy=DegradationPolicy(failure_threshold=2))
        await service.start()
        for i in range(3):
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                await service.submit("glyphs", _raw(1, seed=i))
        res = await service.submit("glyphs", imgs)
        health = service.health().as_dict()     # a snapshot: stop() drains
        await service.stop(drain=True)
        return health, res

    health, res = asyncio.run(run())
    assert health["state"] == "degraded" and health["dispatch_failures"] == 3
    assert health["fallback_path"] is None
    assert engine.stats("glyphs").fallback_path is None
    assert engine.stats("glyphs").degrade_steps == 0
    assert engine.resolved_path("glyphs") == "fused"
    _same(res, ref.classify("glyphs", imgs))


def test_device_loss_on_one_card_retries_member_by_member():
    plan = FaultPlan(device_loss_at=(1,))
    engine, ref = _pair(faults=plan)
    imgs = _raw(2, seed=9)

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=100.0), faults=plan)
        await service.start()
        res = await service.submit("glyphs", imgs)
        await service.stop(drain=True)
        return service, res

    service, res = asyncio.run(run())
    _same(res, ref.classify("glyphs", imgs))
    assert service.health().device_losses == 1 and engine.stats("glyphs").devices == 1


def test_chaos_soak_leaves_no_future_hung():
    plan = FaultPlan(crash_at=(2,), engine_error_at=(3,), slow_dispatch_s=0.0005)
    engine, _ = _pair(faults=plan)
    requests = [_raw(2, seed=i) for i in range(24)]

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=500.0), faults=plan,
                                 policy=DegradationPolicy(restart_backoff_s=0.001))
        await service.start()
        tally = await chaos_soak(service, "glyphs", requests, rate=800.0, deadline_s=2.0,
                                 malformed_frac=0.15, abandon_frac=0.15)
        await service.stop(drain=True)
        return tally

    tally = asyncio.run(run())
    assert tally["hung"] == 0
    resolved = tally["ok"] + tally["expired"] + tally["faulted"] + tally["stopped"]
    assert resolved == tally["admitted"] + tally["abandoned"]
    assert (tally["admitted"] + tally["abandoned"] + tally["rejected"]
            + tally["malformed"]) == len(requests)
    assert tally["malformed"] > 0 and tally["ok"] > 0
    assert tally["health"]["worker_restarts"] >= 1


def test_launcher_service_and_checkpoint_run_on_cpu(tmp_path, capsys):
    """``--service`` and ``--ckpt-dir`` with ``--device cpu``: the service
    mode drains every request, and a restored model serves and reports
    accuracy on the test split."""
    cfg = COTM_CONFIGS["convcotm-mnist"]
    model = init_boundary_model(prng_key(3), cfg)
    save_servable(freeze(model, cfg), str(tmp_path), 1)
    launch_serve.main(["--arch", "convcotm-mnist", "--service", "--requests", "24",
                       "--rate", "4000", "--max-batch", "8", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path), "--malformed-frac", "0.1",
                       "--deadline-s", "30"])
    out = capsys.readouterr().out
    assert "restored model from" in out and "accuracy" in out and "malformed" in out
    assert "queue wait p50" in out and "longest gen-2" in out
    stats = launch_serve.serve_tm("convcotm-mnist", n_requests=2, max_batch=8,
                                  ckpt_dir=str(tmp_path), ingress="host", device="cpu")
    assert stats["requests"] == 2 and stats["compiled_buckets"]
    assert "accuracy" in capsys.readouterr().out
    with pytest.raises(ValueError, match="submit_form"):
        asyncio.run(launch_serve.serve_tm_service("convcotm-mnist", submit_form="bogus",
                                                  device="cpu"))
