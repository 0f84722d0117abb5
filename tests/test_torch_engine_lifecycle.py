"""Port vs reference: the serving engine's lifecycle and fault surface.

The same register -> swap -> rollback sequence, degradation walk and
checkpoint restores run on the reference engine and on the port's
(``device="cpu"``, the kernels' plain versions), and every outcome is held
bit for bit: version ids, stamps, eval paths, predictions and class sums.
The models are the reference's boundary model at the small ``EDGE``
geometry (11x11 images, 5x5 windows, C=37) and seeded weight variants of
it, carried into the port by ``repro_torch.convert``.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import checkpointer as jck
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import CoTMModel as JCoTMModel
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.core.patches import PatchSpec as JPatchSpec
from repro.serve import ServingEngine as JServingEngine
from repro.serve import analyze_sparsity as j_analyze
from repro.serve import freeze as jfreeze
from repro.serve.engine import ServeStats as JServeStats
from repro.serve.servable import ServableVersion as JServableVersion
from repro.serve.servable import servable_digest as j_digest
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.convert import model_from_arrays
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.patches import PatchSpec
from repro_torch.serve.engine import ServeStats, ServingEngine
from repro_torch.serve.faults import FaultPlan, InjectedEngineError
from repro_torch.serve.servable import ServableVersion, analyze_sparsity, freeze

EDGE = dict(image_x=11, image_y=11, window_x=5, window_y=5)
JCFG = JCoTMConfig(n_clauses=37, n_classes=10, patch=JPatchSpec(**EDGE))
TCFG = CoTMConfig(n_clauses=37, n_classes=10, patch=PatchSpec(**EDGE))
PATHS = ("dense", "matmul", "bitpacked", "fused", "kernel", "sparse", "fused_sparse",
         "matmul_sparse")


def _pool(seed=0, per_clause=3.0, empty=0.3):
    """A reference model with a few includes per clause (clauses fire) and
    ~``empty`` of its clauses empty, and its port copy."""
    jm = j_init_boundary(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((37, JCFG.n_literals)) < per_clause / JCFG.n_literals, 133,
                  123).astype(np.uint8)
    ta[rng.random(37) < empty] = 0
    w = np.asarray(jm.weights) + rng.integers(-3, 4, (10, 37)).astype(np.int32)
    return (JCoTMModel(ta_state=jnp.asarray(ta), weights=jnp.asarray(w)),
            model_from_arrays(ta, w))


def _raw(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 11, 11), dtype=np.uint8)


def _same(a, b):
    np.testing.assert_array_equal(a.predictions, b.predictions)
    np.testing.assert_array_equal(a.class_sums, b.class_sums)


def _engines(max_batch=8, faults=None):
    return (JServingEngine(max_batch=max_batch),
            ServingEngine(max_batch=max_batch, device="cpu", faults=faults))


@pytest.mark.parametrize("path", ["fused", "fused_sparse", "matmul_sparse"])
def test_swap_and_rollback_sequence_matches_reference(path):
    """register -> swap -> swap -> rollback -> rollback: equal ids, stamps
    and classify results after every step; the second rollback flips back."""
    je, te = _engines()
    pools = [_pool(seed=s, empty=e) for s, e in ((0, 0.3), (1, 0.0), (2, 0.6))]
    raw = _raw(11, seed=5)
    steps = [("register", 0), ("swap", 1), ("swap", 2), ("rollback", None),
             ("rollback", None)]
    stamps = []
    for op, k in steps:
        if op == "register":
            je.register("m", pools[k][0], JCFG, path=path)
            te.register("m", pools[k][1], TCFG, path=path)
        elif op == "swap":
            js = je.swap("m", pools[k][0], JCFG)
            ts = te.swap("m", pools[k][1], TCFG)
            assert ts.as_dict() == js.as_dict()
        else:
            js, ts = je.rollback("m"), te.rollback("m")
            assert ts.as_dict() == js.as_dict()
        assert te.version_id("m") == je.version_id("m")
        assert te.version("m").as_dict() == je.version("m").as_dict()
        assert te.servable("m").version.as_dict() == je.servable("m").version.as_dict()
        _same(te.classify("m", raw), je.classify("m", raw))
        assert te.classify("m", raw).version == je.classify("m", raw).version
        stamps.append(te.version("m"))
    assert [s.version for s in stamps] == [1, 2, 3, 4, 5]
    # Rollback restores the displaced digest; the second one flips back.
    assert stamps[3].digest == stamps[1].digest and stamps[4].digest == stamps[2].digest
    assert len({s.digest for s in stamps[:3]}) == 3


def test_rollback_is_a_pointer_flip_and_servable_is_memoised():
    _, te = _engines()
    (_, a), (_, b) = _pool(seed=0), _pool(seed=1)
    te.register("m", a, TCFG, path="fused_sparse")
    before = te.servable("m")
    assert te.servable("m") is before                     # one install, one object
    ptrs = (before.include_packed.data_ptr(), before.sparsity.exclude_packed.data_ptr())
    te.swap("m", b, TCFG)
    assert te.servable("m").include_packed.data_ptr() != ptrs[0]
    te.rollback("m")
    after = te.servable("m")
    assert after is not before and after.version.version == 3
    assert (after.include_packed.data_ptr(), after.sparsity.exclude_packed.data_ptr()) == ptrs
    # The dispatched image carries no stamp; servable() adds it.
    assert te._servables["m"].servable.version is None


def test_swap_pads_the_active_pool_and_refuses_what_the_reference_refuses():
    je, te = _engines()
    (jm, tm), (jm2, tm2) = _pool(seed=0), _pool(seed=3, empty=0.5)
    je.register("m", jm, JCFG, path="sparse")
    te.register("m", tm, TCFG, path="sparse")
    je.swap("m", jm2, JCFG)
    te.swap("m", tm2, TCFG)
    want = je.servable("m").sparsity
    got = te.servable("m").sparsity
    assert got.n_active == want.n_active and got.n_active & (got.n_active - 1) == 0
    np.testing.assert_array_equal(got.active_idx.numpy(), np.asarray(want.active_idx))
    assert got.include_density == want.include_density
    other = CoTMConfig(n_clauses=37, n_classes=10, patch=PatchSpec(**EDGE), T=99)
    with pytest.raises(ValueError, match="config mismatch"):
        te.swap("m", freeze(tm2, other))
    with pytest.raises(ValueError, match="config required"):
        te.swap("m", tm2)
    with pytest.raises(KeyError):
        te.swap("nope", tm2, TCFG)
    # retune re-measures on the candidate: the plan carries its digest.
    stamp = te.swap("m", tm2, TCFG, retune=True)
    assert te.servable("m").tuned.digest == stamp.digest == j_digest(jfreeze(jm2, JCFG))
    fresh_j, fresh_t = _engines()
    fresh_j.register("m", jm, JCFG)
    fresh_t.register("m", tm, TCFG)
    with pytest.raises(ValueError, match="no previous version"):
        fresh_j.rollback("m")
    with pytest.raises(ValueError, match="no previous version"):
        fresh_t.rollback("m")


@pytest.mark.parametrize("empty", [0.0, 0.3, 1.0], ids=["full", "pool40", "all_empty"])
def test_include_density_matches_reference(empty):
    jm, tm = _pool(seed=4, empty=empty)
    want = j_analyze(jfreeze(jm, JCFG)).sparsity.include_density
    assert analyze_sparsity(freeze(tm, TCFG)).sparsity.include_density == want


@pytest.mark.parametrize("start", PATHS)
def test_degrade_path_walks_the_reference_chain(start):
    je, te = _engines()
    jm, tm = _pool(seed=6)
    je.register("m", jm, JCFG, path=start)
    te.register("m", tm, TCFG, path=start)
    raw = _raw(5, seed=7)
    chain = [start]
    while True:
        _same(te.classify("m", raw), je.classify("m", raw))
        nxt_j, nxt_t = je.degrade_path("m"), te.degrade_path("m")
        assert nxt_t == nxt_j
        if nxt_t is None:
            break
        chain.append(nxt_t)
        assert te.ingress_spec("m").packed == je.ingress_spec("m").packed
        assert te.stats("m").fallback_path == je.stats("m").fallback_path == nxt_t
        assert te.stats("m").degrade_steps == je.stats("m").degrade_steps == len(chain) - 1
    assert chain[-1] == "dense"


def test_serve_stats_models_and_one_card_surface_match_reference():
    je, te = _engines()
    jm, tm = _pool(seed=8)
    for name in ("zeta", "alpha", "mid"):
        je.register(name, jm, JCFG)
        te.register(name, tm, TCFG)
    assert te.models() == je.models() == ("alpha", "mid", "zeta")
    assert te.warmup("alpha") == je.warmup("alpha") == (1, 2, 4, 8)
    assert te.warmup("alpha") == je.warmup("alpha") == ()
    _same(te.classify("alpha", _raw(11, seed=9)), je.classify("alpha", _raw(11, seed=9)))
    got, want = te.stats("alpha").as_dict(), je.stats("alpha").as_dict()
    assert list(got) == list(want)
    for key in ("requests", "images", "bucket_hits", "compiled_buckets", "devices",
                "data_shards", "per_device_bucket_hits", "autotune", "fallback_path",
                "degrade_steps"):
        assert got[key] == want[key], key
    assert [f.name for f in dataclasses.fields(ServeStats)] == \
        [f.name for f in dataclasses.fields(JServeStats)]
    assert (te.devices, te.data_shards) == (je.devices, je.data_shards) == (1, 1)
    assert te.shrink_mesh() is None and je.shrink_mesh() is None
    with pytest.raises(TypeError, match="mesh"):
        ServingEngine(device="cpu", mesh=object())


def test_fault_seam_and_dispatch_version():
    """The engine's chaos seam raises before any work; a dispatch holds its
    version and its image until result(), whatever is swapped meanwhile."""
    plan = FaultPlan(engine_error_at=(2,))
    _, te = _engines(faults=plan)
    (_, a), (_, b) = _pool(seed=0), _pool(seed=1)
    te.register("m", a, TCFG)
    ref_a = ServingEngine(max_batch=8, device="cpu")
    ref_a.register("m", a, TCFG)
    raw = _raw(19, seed=10)                     # three slices of max_batch 8
    first = te.dispatch("m", raw)
    with pytest.raises(InjectedEngineError):
        te.dispatch("m", raw)
    assert te.stats("m").requests == 0
    held = first._servable
    te.swap("m", b, TCFG)
    assert first.version == 1 and first._servable is held
    res = first.result()
    assert res.version == 1 and first._servable is None
    _same(res, ref_a.classify("m", raw))
    assert te.classify("m", raw).version == 2
    assert plan.engine_dispatches == 3


def test_concurrent_swaps_never_split_a_request_across_versions():
    """Dispatch threads against a swap/rollback thread: every request, over
    max_batch and so served in slices, equals one version's classify."""
    _, te = _engines(max_batch=4)
    pools = [_pool(seed=s)[1] for s in (0, 1)]
    te.register("m", pools[0], TCFG, path="fused")
    refs = []
    for tm in pools:
        r = ServingEngine(max_batch=4, device="cpu")
        r.register("m", tm, TCFG, path="fused")
        refs.append(r)
    raw = _raw(10, seed=11)
    wants = [r.classify("m", raw) for r in refs]
    assert not np.array_equal(wants[0].class_sums, wants[1].class_sums)
    got, errors = [], []

    def serve():
        try:
            for _ in range(12):
                got.append(te.classify("m", raw))
        except Exception as e:  # noqa: BLE001 -- reported by the assert below
            errors.append(e)

    def storm():
        te.swap("m", pools[1], TCFG)
        for _ in range(10):
            te.rollback("m")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve) for _ in range(4)]
        threads.append(threading.Thread(target=storm))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 48 and te.version_id("m") == 12
    for res in got:
        # Odd ids serve pool 0 (register, even rollbacks), even ids pool 1.
        _same(res, wants[(res.version + 1) % 2])


@pytest.mark.parametrize("flavour", ["model", "servable"])
def test_load_checkpoint_both_flavours_match_reference(tmp_path, flavour):
    jm, tm = _pool(seed=12)
    stamp = ServableVersion(version=7, epoch=3, step=11, digest="feedfacecafe")
    if flavour == "model":
        tck.save_pytree(tm, str(tmp_path), 3,
                        extra={"servable_version": stamp.as_dict(), "tuned_plan": ""})
    else:
        tck.save_servable(freeze(tm, TCFG).replace(version=stamp), str(tmp_path), 3)
    je, te = _engines()
    je.load_checkpoint("m", str(tmp_path), JCFG, path="fused_sparse")
    got = te.load_checkpoint("m", str(tmp_path), TCFG, path="fused_sparse")
    assert got.sparsity is not None and te.resolved_path("m") == "fused_sparse"
    assert te.version("m").as_dict() == je.version("m").as_dict()
    assert te.version("m") == ServableVersion(1, 3, 11, "feedfacecafe")
    raw = _raw(6, seed=13)
    _same(te.classify("m", raw), je.classify("m", raw))
    with pytest.raises(FileNotFoundError):
        te.load_checkpoint("m", str(tmp_path / "none"), TCFG)
    # The reference's own trainer checkpoint restores in the port too.
    jck.save_pytree(jm, str(tmp_path / "ref"), 1)
    te.load_checkpoint("r", str(tmp_path / "ref"), TCFG)
    je.load_checkpoint("r", str(tmp_path / "ref"), JCFG)
    assert te.version("r").as_dict() == je.version("r").as_dict()
    _same(te.classify("r", raw), je.classify("r", raw))
    assert JServableVersion().as_dict() == ServableVersion().as_dict()
