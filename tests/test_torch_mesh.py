"""Port vs reference: serving across a device mesh (``serve/mesh.py``,
``launch/mesh.py``, the meshed engine, service, autotuner and launcher).

The reference's own contract is that a meshed engine equals the unmeshed
one bit for bit (``tests/test_serve_mesh.py``), so the port's meshed
engine is held against the reference's **unmeshed** engine: the same
numpy requests, in raw, host-ingress and preprocessed form, on every eval
path.  The port's meshes repeat the CPU (1, 2 and 4 data shards, 2 and 4
clause shards, 2x4), which runs every meshed code path in one process;
the reference's one-device meshes are compared directly.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.core.patches import PatchSpec as JPatchSpec
from repro.serve import ServingEngine as JServingEngine
from repro.serve import make_serve_mesh as j_make_serve_mesh
from repro_torch.convert import model_from_arrays
from repro_torch.core.cotm import CoTMConfig, init_boundary_model
from repro_torch.core.patches import PatchSpec
from repro_torch.core.prng import prng_key
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import DeviceMesh, make_serve_device_mesh, make_test_mesh
from repro_torch.serve import autotune as tat
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.mesh import ServeMesh, classify_step_meshed, make_serve_mesh
from repro_torch.serve.service import ServiceConfig, ServingService

PATCH = dict(image_x=11, image_y=11, window_x=5, window_y=5)
# 40 clauses: every clause-sharded mesh here (2, 4) splits evenly.
JCFG = JCoTMConfig(n_clauses=40, n_classes=10, patch=JPatchSpec(**PATCH))
TCFG = CoTMConfig(n_clauses=40, n_classes=10, patch=PatchSpec(**PATCH))
PATHS = ("dense", "matmul", "bitpacked", "kernel", "fused", "sparse", "fused_sparse",
         "matmul_sparse")
#: (data, model, shard_clauses)
GEOMETRIES = [(1, 1, False), (1, 1, True), (2, 1, False), (4, 1, False), (1, 2, True),
              (1, 4, True), (2, 4, False), (2, 4, True)]
GEOM_IDS = [f"{d}x{m}{'-clause' if c else ''}" for d, m, c in GEOMETRIES]


def _models(seed=0):
    """A pool with a few includes per clause (clauses fire, sums are
    nonzero) and ~a quarter of its clauses empty, in both packages."""
    jm = j_init_boundary(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random(jm.ta_state.shape) < 0.06, 133, 123).astype(np.uint8)
    ta[rng.random(ta.shape[0]) < 0.25] = 0
    jm = dataclasses.replace(jm, ta_state=jnp.asarray(ta))
    return jm, model_from_arrays(ta, np.asarray(jm.weights))


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 11, 11), dtype=np.uint8)


def _same(got, want):
    np.testing.assert_array_equal(got.predictions, np.asarray(want.predictions))
    np.testing.assert_array_equal(got.class_sums, np.asarray(want.class_sums))


def _meshed(tm, data, model=1, shard_clauses=False, *, path="fused", max_batch=32, **kw):
    eng = ServingEngine(max_batch, mesh=ServeMesh(make_test_mesh(data, model), shard_clauses),
                        **kw)
    eng.register("m", tm, TCFG, path=path)
    return eng


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def reference(models):
    """The reference's unmeshed engine's results per path: raw, host and
    preprocessed forms of a 13-image request, and one image raw."""
    jm, _ = models
    out = {}
    for path in PATHS:
        eng = JServingEngine(max_batch=32)
        eng.register("m", jm, JCFG, path=path)
        imgs, one = _images(13, seed=3), _images(1, seed=4)
        out[path] = {
            "raw": eng.classify("m", imgs),
            "host": eng.classify("m", imgs, ingress="host"),
            "preprocessed": eng.classify("m", eng.preprocess("m", imgs), preprocessed=True),
            "one": eng.classify("m", one),
        }
        assert np.asarray(out[path]["raw"].class_sums).any()
    return out


# --- bit identity against the reference -------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOM_IDS)
def test_meshed_engine_equals_unmeshed_reference(models, reference, geometry, path):
    data, model, shard = geometry
    eng = _meshed(models[1], data, model, shard, path=path)
    want = reference[path]
    imgs, one = _images(13, seed=3), _images(1, seed=4)
    _same(eng.classify("m", imgs), want["raw"])
    _same(eng.classify("m", imgs, ingress="host"), want["host"])
    _same(eng.classify("m", eng.preprocess("m", imgs), preprocessed=True),
          want["preprocessed"])
    res = eng.classify("m", one)
    _same(res, want["one"])
    assert res.bucket == max(1, data)
    # Clause-sharded placement drops the sparsity image: sparse names
    # resolve to their dense twins; replicated placement keeps it.
    assert (eng.servable("m").sparsity is None) == shard
    st = eng.stats("m")
    assert (st.devices, st.data_shards) == (data * model, data)


@pytest.mark.parametrize("shard_clauses", [False, True])
@pytest.mark.parametrize("path", ["fused", "dense", "sparse"])
def test_one_device_meshes_equal_the_reference_one_device_meshes(models, path, shard_clauses):
    """The reference's make_serve_mesh(1, 1), replicated and clause-sharded,
    against the port's one-device meshes of the same modes."""
    jm, tm = models
    jeng = JServingEngine(max_batch=32, mesh=j_make_serve_mesh(1, 1,
                                                               shard_clauses=shard_clauses))
    jeng.register("m", jm, JCFG, path=path)
    eng = _meshed(tm, 1, 1, shard_clauses, path=path)
    for n, seed in ((9, 7), (32, 8), (40, 9)):
        imgs = _images(n, seed=seed)
        for kw in ({}, {"ingress": "host"}):
            _same(eng.classify("m", imgs, **kw), jeng.classify("m", imgs, **kw))
    assert eng.stats("m").as_dict()["per_device_bucket_hits"] == \
        jeng.stats("m").as_dict()["per_device_bucket_hits"]


# --- geometry and placement ---------------------------------------------------

def test_serve_mesh_geometry_errors(models):
    with pytest.raises(ValueError, match='"data" axis'):
        ServeMesh(DeviceMesh([["cpu"]], ("a", "b")))
    with pytest.raises(ValueError, match='"model" axis'):
        ServeMesh(DeviceMesh(["cpu"], ("data",)), shard_clauses=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeMesh(object())
    cfg = dataclasses.replace(TCFG, n_clauses=7)
    odd = init_boundary_model(prng_key(0), cfg)
    with pytest.raises(ValueError, match="does not divide"):
        ServingEngine(8, mesh=ServeMesh(make_test_mesh(1, 2), True)).register("m", odd, cfg)
    ServingEngine(1, mesh=make_test_mesh(1, 1))            # 1 divides everything
    with pytest.raises(ValueError, match="power of two"):
        ServingEngine(8, mesh=make_test_mesh(3, 1))
    with pytest.raises(ValueError, match="exceeds max_batch"):
        ServingEngine(1, mesh=make_test_mesh(2, 1))
    with pytest.raises(TypeError, match="mesh"):
        ServingEngine(8, mesh=object())
    with pytest.raises(ValueError, match="first device"):
        ServingEngine(8, mesh=make_test_mesh(2, 1), device="meta")


def test_device_mesh_shapes_and_validation():
    mesh = DeviceMesh([["cpu", "cpu"], ["cpu", "cpu"], ["cpu", "cpu"]])
    assert mesh.shape == {"data": 3, "model": 2} and mesh.size == 6
    assert mesh.along("data") == (torch.device("cpu"),) * 3
    assert mesh.truncated("data", 1).shape == {"data": 1, "model": 2}
    assert hash(mesh) == hash(DeviceMesh((("cpu",) * 2,) * 3))     # hashable, by value
    assert make_test_mesh(2, 3).shape == {"data": 2, "model": 3}
    with pytest.raises(ValueError, match="rectangular"):
        DeviceMesh([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="nest"):
        DeviceMesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="repeat"):
        DeviceMesh([["cpu"]], ("data", "data"))
    with pytest.raises(ValueError, match="not in mesh axes"):
        mesh.along("pod")


def test_make_serve_device_mesh_names_the_explicit_mesh_without_cards():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA cards")
    with pytest.raises(ValueError, match=r"DeviceMesh\(\[\['cuda:0'\] \* 1\] \* 2\)"):
        make_serve_device_mesh(2, 1)
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        make_serve_mesh(2, 2)


def test_bucket_clamped_to_data_shards(models):
    eng = _meshed(models[1], 1)
    assert (eng.bucket_for(1), eng.bucket_for(3)) == (1, 4)
    eng = _meshed(models[1], 4)
    assert eng.data_shards == 4
    assert (eng.bucket_for(1), eng.bucket_for(3), eng.bucket_for(5)) == (4, 4, 8)


def test_stats_and_per_device_bucket_accounting(models):
    eng = _meshed(models[1], 8, max_batch=64)
    eng.classify("m", _images(16))
    eng.classify("m", _images(3))               # bucket 4, clamped to 8
    st = eng.stats("m")
    assert st.devices == 8 and st.bucket_hits == {16: 1, 8: 1}
    assert st.per_device_bucket_hits == {2: 1, 1: 1}
    assert st.as_dict()["per_device_bucket_hits"] == {2: 1, 1: 1}
    eng = _meshed(models[1], 1)
    eng.classify("m", _images(5))
    assert eng.stats("m").as_dict()["per_device_bucket_hits"] == {8: 1}


def test_place_batch_splits_rows_over_the_data_axis():
    smesh = ServeMesh(make_test_mesh(4, 2), shard_clauses=True)
    x = _images(16)
    parts = smesh.place_batch(x)
    assert [p.shape[0] for p in parts] == [4] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    words = np.arange(8 * 3, dtype=np.uint32).reshape(8, 1, 3) | np.uint32(1 << 31)
    assert smesh.place_batch(words)[0].dtype == torch.int32
    with pytest.raises(ValueError, match="does not divide over 4"):
        smesh.place_batch(_images(6))


def test_place_servable_replicated_and_clause_sharded(models):
    tm = models[1]
    rep = _meshed(tm, 2, 2, False)
    placed = rep._servables["m"].servable
    shards = placed.placement.shards
    assert placed.version is None and placed.sparsity is not None
    # One device repeated: every grid position shares one copy.
    assert all(s is shards[0][0] for row in shards for s in row)

    eng = _meshed(tm, 2, 4, True)
    placed = eng._servables["m"].servable
    shards = placed.placement.shards
    assert placed.sparsity is None and placed.n_clauses == 40
    full = placed
    for row in shards:
        for m, s in enumerate(row):
            sl = slice(10 * m, 10 * (m + 1))
            assert s.n_clauses == 10 and s.weights.is_contiguous()
            assert s.weights.shape == (10, 10) and s.include_packed.is_contiguous()
            torch.testing.assert_close(s.weights, full.weights[:, sl].contiguous(),
                                       rtol=0, atol=0)
            assert torch.equal(s.nonempty, full.nonempty[sl])
    assert shards[0][1] is shards[1][1]            # same device, same slice: one copy
    # The stamped image keeps its version; the dispatch image carries none.
    assert eng.servable("m").version.version == 1


def test_meshed_step_refuses_an_image_placed_elsewhere(models):
    eng = _meshed(models[1], 2)
    other = ServeMesh(make_test_mesh(4, 1))
    with pytest.raises(ValueError, match="not placed on this mesh"):
        classify_step_meshed(eng._servables["m"].servable, other.place_batch(_images(4)),
                             other, "fused")


def test_warmup_and_dispatch_on_a_mesh(models):
    eng = _meshed(models[1], 2, 2, True)
    assert eng.warmup("m", buckets=[2, 8]) == (2, 8)
    assert eng.stats("m").requests == 0
    handle = eng.dispatch("m", _images(5))
    assert handle._done == ()                      # the CPU: complete at dispatch
    res = handle.result()
    assert res is handle.result() and res.bucket == 8


# --- lifecycle on a mesh --------------------------------------------------------

def test_shrink_mesh_4_2_1_keeps_results(models, reference):
    eng = _meshed(models[1], 4, path="fused_sparse")
    imgs = _images(13, seed=3)
    seen = []
    while True:
        _same(eng.classify("m", imgs), reference["fused_sparse"]["raw"])
        seen.append((eng.data_shards, eng.stats("m").data_shards, eng.bucket_for(1)))
        if eng.shrink_mesh() is None:
            break
    assert seen == [(4, 4, 4), (2, 2, 2), (1, 1, 1)]
    assert eng.devices == 1 and eng.shrink_mesh() is None
    assert ServingEngine(8, device="cpu").shrink_mesh() is None


def test_shrink_keeps_the_model_axis_and_rollback_after_it(models, reference):
    jm, tm = models
    eng = _meshed(tm, 2, 2, True, path="kernel")
    _, other = _models(seed=1)
    eng.swap("m", other, TCFG)
    new = eng.shrink_mesh()
    assert (new.n_data, new.n_model, new.shard_clauses) == (1, 2, True)
    eng.rollback("m")                                # the displaced image, re-placed
    _same(eng.classify("m", _images(13, seed=3)), reference["kernel"]["raw"])


async def _serve(service, batches):
    await service.start()
    futs = [asyncio.ensure_future(service.submit("m", b)) for b in batches]
    done, pending = await asyncio.wait(futs, timeout=60)
    await service.stop(drain=True)
    return [f.result() for f in futs if f in done], len(pending)


def test_device_lost_shrinks_4_2_1_and_stays_bit_identical(models, reference):
    """Two injected device losses, on the first two microbatches: each
    shrinks the data axis and the batch is retried member by member."""
    plan = FaultPlan(device_loss_at=(1, 2))
    eng = _meshed(models[1], 4, path="fused")
    service = ServingService(eng, ServiceConfig(max_delay_us=100.0), faults=plan)
    imgs = _images(13, seed=3)

    async def run():
        await service.start()
        shards, results = [], []
        for _ in range(3):
            results.append(await asyncio.wait_for(service.submit("m", imgs), 60))
            shards.append(eng.data_shards)
        await service.stop(drain=True)
        return shards, results

    shards, results = asyncio.run(run())
    assert shards == [2, 1, 1]
    for res in results:
        _same(res, reference["fused"]["raw"])
    assert eng.stats("m").data_shards == 1 and service.health().device_losses == 2


@pytest.mark.parametrize("geometry", [(4, 1, False), (2, 2, True)], ids=["data4", "2x2"])
def test_service_on_a_mesh_is_bit_identical(models, geometry):
    jm, tm = models
    ref = JServingEngine(max_batch=32)
    ref.register("m", jm, JCFG, path="fused")
    eng = _meshed(tm, *geometry)
    service = ServingService(eng, ServiceConfig(max_delay_us=500.0))
    sizes = [1, 3, 7, 2, 5, 1, 4, 6, 2, 1]
    batches = [_images(n, seed=10 + i) for i, n in enumerate(sizes)]
    results, hung = asyncio.run(_serve(service, batches))
    assert hung == 0 and len(results) == len(batches)
    for b, r in zip(batches, results):
        _same(r, ref.classify("m", b))


def test_max_coalesce_scales_with_data_shards(models):
    eng = _meshed(models[1], 4)
    assert ServingService(eng, ServiceConfig(max_coalesce=8))._sched.max_coalesce == 32
    plain = ServingEngine(32, device="cpu")
    assert ServingService(plain, ServiceConfig(max_coalesce=8))._sched.max_coalesce == 8
    eng8 = _meshed(models[1], 8, max_batch=32)
    assert ServingService(eng8, ServiceConfig(max_coalesce=8))._sched.max_coalesce == 32
    big = ServingEngine(16, device="cpu")
    assert ServingService(big, ServiceConfig(max_coalesce=64))._sched.max_coalesce == 64


# --- the autotuner on a mesh ----------------------------------------------------

@pytest.mark.parametrize("shard_clauses", [False, True])
def test_autotune_on_a_mesh_measures_the_meshed_step_at_defaults(models, reference,
                                                                 monkeypatch, shard_clauses):
    """Even where parameters would be swept, a mesh measures default
    parameters only, through the meshed step; clause-sharded meshes have
    no sparse candidates (their images carry no sparsity image)."""
    monkeypatch.setattr(tat, "_sweeps_params", lambda device: True)
    measured = []
    measure = tat._measure

    def probe(*a, **k):
        measured.append((a[1], a[2], k.get("smesh")))
        return measure(*a, **k)

    monkeypatch.setattr(tat, "_measure", probe)
    tat.clear_measure_memo()
    try:
        eng = ServingEngine(8, mesh=ServeMesh(make_test_mesh(2, 2), shard_clauses),
                            autotune=True, autotune_repeats=1)
        eng.register("m", models[1], TCFG, path="fused")
        eng.warmup("m", buckets=[2, 8])
    finally:
        tat.clear_measure_memo()
    plan = eng.servable("m").tuned
    assert {(f, b) for f, b, _, _ in plan.entries} == {("literals", 2), ("literals", 8),
                                                      ("raw", 2), ("raw", 8)}
    assert all(params == () for _, _, _, params in plan.entries)
    assert measured and all(p == () and sm == eng.mesh for _, p, sm in measured)
    names = {n for n, _, _ in measured}
    assert ("sparse" in names) != shard_clauses and "fused" in names
    imgs = _images(13, seed=3)
    for kw in ({}, {"ingress": "host"}):
        _same(eng.classify("m", imgs, **kw), reference["fused"]["raw"])


def test_autotune_memo_key_holds_the_mesh(models, monkeypatch):
    calls = []
    measure = tat._measure
    monkeypatch.setattr(tat, "_measure", lambda *a, **k: calls.append(k["smesh"]) or
                        measure(*a, **k))
    tat.clear_measure_memo()
    try:
        for data in (1, 2, 2):
            eng = _meshed(models[1], data, max_batch=4)
            eng.autotune("m", buckets=[4], forms=("raw",), repeats=1)
    finally:
        tat.clear_measure_memo()
    meshes = list(dict.fromkeys(calls))
    assert [m.n_data for m in meshes] == [1, 2]        # the second data-2 engine: memo hits


# --- the launcher -----------------------------------------------------------------

def test_parse_serve_mesh():
    assert launch_serve.parse_serve_mesh(None) is None
    m = launch_serve.parse_serve_mesh("4", device="cpu")
    assert (m.n_data, m.n_model, m.shard_clauses) == (4, 1, False)
    m = launch_serve.parse_serve_mesh("2", "clause", device="cpu")
    assert (m.n_data, m.n_model, m.shard_clauses) == (1, 2, True)
    m = launch_serve.parse_serve_mesh("2x4", device="cpu")
    assert (m.n_data, m.n_model, m.shard_clauses) == (2, 4, True)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 CUDA devices"):
            launch_serve.parse_serve_mesh("2")


def test_launcher_serves_on_a_cpu_mesh(capsys):
    launch_serve.main(["--arch", "convcotm-mnist", "--requests", "3", "--max-batch", "8",
                       "--mesh", "2x2", "--device", "cpu", "--eval-path", "kernel"])
    out = capsys.readouterr().out
    assert '2x2 ("data","model") mesh (clause-sharded)' in out
    assert '"data_shards": 2' in out and '"devices": 4' in out
