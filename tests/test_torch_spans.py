"""The port's spans (``repro_torch.spans``): host ranges under
``torch.profiler`` on every thread, recorded as ``cpu_op`` and never as a
``user_annotation`` (which the profiler shows again on the card as a
device range); the engine's, ingress's and classify's spans nested on the
dispatching thread; the service's on its own threads; the trainer's as
host ranges; answers the same with a profiler running and without."""

import asyncio
import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.cotm import CoTMConfig, init_boundary_model
from repro_torch.core.patches import PatchSpec
from repro_torch.core.prng import prng_key
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.service import ServiceConfig, ServingService
from repro_torch.spans import span
from repro_torch.train.tm_engine import TrainerEngine

EDGE = dict(image_x=11, image_y=11, window_x=5, window_y=5)
CFG = CoTMConfig(n_clauses=37, n_classes=10, patch=PatchSpec(**EDGE))
ENGINE_SPANS = ("engine.dispatch", "engine.stage_in", "ingress.booleanize", "ingress.pack",
                "classify.clauses", "classify.argmax", "engine.stage_out", "engine.result",
                "engine.wait", "engine.unpack")


def _all_threads(**kw):
    """``torch.profiler`` as the benchmark's tracer runs it: operators of
    every thread."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], experimental_config=cfg, **kw)


def _program_events(prof):
    """(name, thread, start, end) of the program's spans, in start order."""
    prefixes = ("engine.", "ingress.", "classify.", "service.", "train.", "gc.")
    return sorted(((e.name, e.thread, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefixes)),
                  key=lambda e: e[2])


def _chrome_cats(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {(e["name"], e.get("cat")) for e in json.loads(path.read_text())["traceEvents"]
            if "name" in e}


def _engine(method="adaptive"):
    engine = ServingEngine(max_batch=16, device="cpu")
    engine.register("glyphs", init_boundary_model(prng_key(4), CFG), CFG, path="fused",
                    booleanize_method=method)
    return engine


def _raw(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 11, 11), dtype=np.uint8)


def test_span_is_a_cpu_op_on_every_thread_and_keeps_its_values(tmp_path):
    def work():
        with span("service.dispatch", batch_id=7):
            torch.ones(3).add_(1)

    with _all_threads() as prof:
        work()
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    got = [(n, th) for n, th, _, _ in _program_events(prof)]
    assert [n for n, _ in got] == ["service.dispatch"] * 2
    assert got[0][1] != got[1][1]                       # one on each thread
    assert ("service.dispatch", "cpu_op") in _chrome_cats(prof, tmp_path)
    # Recording shapes, the profiler keeps the keyword values.
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        work()
    (ev,) = [e for e in prof.events() if e.name == "service.dispatch"]
    assert ev.kwinputs == {"batch_id": 7}


@pytest.mark.parametrize("method", ["adaptive", "threshold"])
def test_engine_spans_nest_inside_dispatch_and_result(method, tmp_path):
    engine = _engine(method)
    engine.warmup("glyphs", buckets=[4, 16], forms=("raw",))
    calls = [_raw(n, seed=i) for i, n in enumerate((3, 16, 1, 9))]
    with _all_threads() as prof:
        for raw in calls:
            engine.dispatch("glyphs", raw).result()
    evs = _program_events(prof)
    counts = Counter(n for n, *_ in evs)
    assert counts["engine.dispatch"] == counts["engine.result"] == len(calls)
    for name in ENGINE_SPANS:
        assert counts[name] >= len(calls), (name, counts)
    dispatches = [e for e in evs if e[0] == "engine.dispatch"]
    for name, thread, s, e in evs:
        if name.startswith(("ingress.", "classify.", "engine.stage_in")):
            assert any(th == thread and ds <= s and e <= de
                       for _, th, ds, de in dispatches), name
    results = [e for e in evs if e[0] == "engine.result"]
    for name, thread, s, e in evs:
        if name in ("engine.wait", "engine.unpack"):
            assert any(th == thread and rs <= s and e <= re for _, th, rs, re in results)
    cats = _chrome_cats(prof, tmp_path)
    assert {c for n, c in cats if n in ENGINE_SPANS} == {"cpu_op"}


def test_answers_are_the_same_under_the_profiler():
    engine = _engine()
    calls = [_raw(n, seed=10 + i) for i, n in enumerate((5, 16, 2))]
    plain = [engine.classify("glyphs", raw) for raw in calls]
    with _all_threads():
        traced = [engine.classify("glyphs", raw) for raw in calls]
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a.predictions, b.predictions)
        np.testing.assert_array_equal(a.class_sums, b.class_sums)


def test_service_spans_on_their_threads():
    engine = _engine()

    async def run():
        service = ServingService(engine, ServiceConfig(max_delay_us=200.0))
        await service.start()
        results = await asyncio.gather(*(service.submit("glyphs", _raw(1, seed=i))
                                         for i in range(6)))
        await service.stop(drain=True)
        return results

    with _all_threads() as prof:
        results = asyncio.run(run())
    evs = _program_events(prof)
    threads = {}
    for name, thread, *_ in evs:
        threads.setdefault(name, set()).add(thread)
    assert Counter(n for n, *_ in evs)["service.admit"] == 6
    batches = {r.batch_id for r in results}
    for name in ("service.dispatch", "service.complete"):
        assert Counter(n for n, *_ in evs)[name] == len(batches)
    admit, = threads["service.admit"]
    (dispatch,), (complete,) = threads["service.dispatch"], threads["service.complete"]
    assert len({admit, dispatch, complete}) == 3
    assert threads["engine.dispatch"] == {dispatch} and threads["engine.result"] == {complete}


def test_trainer_spans_are_host_ranges(tmp_path):
    """One step of ``TrainerEngine.run_epoch`` from a key: its draws, and
    the step's matmul, feedback and apply, each once, as host ranges."""
    eng = TrainerEngine(CFG, batch_size=4, device="cpu")
    ds = eng.prepare(_raw(4, seed=3), np.array([0, 3, 5, 9]), booleanize_method="threshold")
    model = init_boundary_model(prng_key(2), CFG)
    with _all_threads() as prof:
        eng.run_epoch(prng_key(5), model, ds)
    names = Counter(n for n, *_ in _program_events(prof))
    for part in ("train.draws", "train.matmul", "train.feedback", "train.apply"):
        assert names[part] == 1, names
    cats = _chrome_cats(prof, tmp_path)
    assert {c for n, c in cats if n.startswith("train.")} == {"cpu_op"}
