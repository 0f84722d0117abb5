"""Port vs reference: freeze, the eval paths, ingress, and the serving engine.

The model comes from ``repro.core.cotm.init_boundary_model`` and is
carried into the port by ``repro_torch.convert``; the same numpy request
batches go through both packages, and every output (packed words, class
sums, predictions) is held bit for bit.  The port runs with
``device="cpu"``, where each kernel takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clauses as jcl
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.core.ingress import IngressSpec as JIngressSpec
from repro.core.ingress import apply_ingress as j_apply_ingress
from repro.core.patches import PatchSpec as JPatchSpec
from repro.core.patches import pack_bits as jpack
from repro.serve import ServingEngine as JServingEngine
from repro.serve import analyze_sparsity as j_analyze
from repro.serve import freeze as jfreeze
from repro.serve import paths as jpaths
from repro_torch.configs.convcotm import BOOLEANIZE_METHOD, COTM_CONFIGS
from repro_torch.convert import model_from_arrays, words_from_uint32, words_to_uint32
from repro_torch.core import clauses as tcl
from repro_torch.core.cotm import CoTMConfig, init_boundary_model, init_model
from repro_torch.core.ingress import IngressSpec, apply_ingress, raw_trailing_shape
from repro_torch.core.patches import PatchSpec
from repro_torch.core.prng import prng_key
from repro_torch.launch.serve import serve_tm
from repro_torch.serve import paths as tpaths
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.servable import analyze_sparsity, freeze

EDGE = dict(image_x=11, image_y=11, window_x=5, window_y=5)
PATHS = ("dense", "matmul", "bitpacked", "fused", "kernel", "sparse", "fused_sparse",
         "matmul_sparse")
NEW_PATHS = PATHS[4:]


def _models(patch_kw, n_clauses, seed=0, n_classes=10):
    """The reference boundary model and its port copy."""
    jcfg = JCoTMConfig(n_clauses=n_clauses, n_classes=n_classes, patch=JPatchSpec(**patch_kw))
    tcfg = CoTMConfig(n_clauses=n_clauses, n_classes=n_classes, patch=PatchSpec(**patch_kw))
    jm = j_init_boundary(jax.random.PRNGKey(seed), jcfg)
    return jm, jcfg, model_from_arrays(jm.ta_state, jm.weights), tcfg


def _few_includes(jm, tm, seed=0, per_clause=3.0):
    """Replace both models' TA states by a pool with a few includes per
    clause, so clauses fire and class sums are nonzero."""
    ta = np.asarray(jm.ta_state)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random(ta.shape) < per_clause / ta.shape[1], 133, 123).astype(np.uint8)
    jm = dataclasses.replace(jm, ta_state=jnp.asarray(ta))
    return jm, model_from_arrays(ta, np.asarray(jm.weights))


def _raw(n, y, x, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, y, x), dtype=np.uint8)


def test_freeze_matches_reference():
    jm, jcfg, tm, tcfg = _models(EDGE, 37)
    js, ts = jfreeze(jm, jcfg), freeze(tm, tcfg)
    np.testing.assert_array_equal(np.asarray(js.include), ts.include.numpy())
    np.testing.assert_array_equal(np.asarray(js.include_packed),
                                  words_to_uint32(ts.include_packed))
    np.testing.assert_array_equal(np.asarray(js.nonempty), ts.nonempty.numpy())
    np.testing.assert_array_equal(np.asarray(js.weights), ts.weights.numpy())
    assert ts.weights.dtype == torch.int8 and ts.include_packed.dtype == torch.int32
    assert (ts.n_clauses, ts.n_classes) == (37, 10)
    assert set(dict(ts.named_buffers())) == {"include", "include_packed", "nonempty", "weights"}


def test_freeze_clamps_weights_to_int8():
    cfg = CoTMConfig(n_clauses=4, n_classes=2, patch=PatchSpec(**EDGE))
    tm = init_model(prng_key(0), cfg)
    tm.weights = torch.tensor([[300, -300, 5, -127], [127, 128, -128, 0]], dtype=torch.int32)
    assert freeze(tm, cfg).weights.tolist() == [[127, -127, 5, -127], [127, 127, -127, 0]]


@pytest.mark.parametrize("few", [False, True], ids=["boundary", "few_includes"])
@pytest.mark.parametrize("path", PATHS)
def test_run_path_matches_reference(path, few):
    jm, jcfg, tm, tcfg = _models(EDGE, 37, seed=1)
    if few:
        jm, tm = _few_includes(jm, tm, seed=2)
    # With the sparsity image attached, the sparse paths run themselves.
    js, ts = j_analyze(jfreeze(jm, jcfg)), analyze_sparsity(freeze(tm, tcfg))
    jp, tp_ = jpaths.get_path(path), tpaths.get_path(path)
    assert tpaths.resolve_path(tp_, ts) is tp_
    assert tp_.input_form == jp.input_form
    raw = _raw(6, 11, 11, seed=3)
    jl = j_apply_ingress(jp.ingress_spec(jcfg.patch), jnp.asarray(raw))
    tl = apply_ingress(tp_.ingress_spec(tcfg.patch), torch.from_numpy(raw))
    if tp_.input_form == tpaths.PACKED:
        np.testing.assert_array_equal(np.asarray(jl), words_to_uint32(tl))
    want = np.asarray(jpaths.run_path(jp, js, jl))
    got = tpaths.run_path(tp_, ts, tl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        want, tpaths.run_path_raw(tp_, ts, torch.from_numpy(raw), tp_.ingress_spec(tcfg.patch))
    )
    if few:
        assert want.any()


def test_paths_at_paper_geometry_match_reference():
    """Every path on the paper configuration, a few-include pool."""
    jm, jcfg, tm, tcfg = _models({}, 128, seed=4)
    jm, tm = _few_includes(jm, tm, seed=5)
    js, ts = j_analyze(jfreeze(jm, jcfg)), analyze_sparsity(freeze(tm, tcfg))
    raw = _raw(2, 28, 28, seed=6)
    want = None
    for path in PATHS:
        jp, tp_ = jpaths.get_path(path), tpaths.get_path(path)
        jl = j_apply_ingress(jp.ingress_spec(jcfg.patch), jnp.asarray(raw))
        got = tpaths.run_path_raw(tp_, ts, torch.from_numpy(raw), tp_.ingress_spec(tcfg.patch))
        want = np.asarray(jpaths.run_path(jp, js, jl))
        np.testing.assert_array_equal(want, got.numpy())
    assert want.any()


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("method", ["threshold", "none"])
def test_apply_ingress_matches_reference(method, packed):
    raw = _raw(4, 11, 11, seed=7)
    if method == "none":
        raw = (raw > 128).astype(np.uint8)
    want = j_apply_ingress(JIngressSpec(JPatchSpec(**EDGE), method=method, packed=packed,
                                        threshold=90), jnp.asarray(raw))
    spec = IngressSpec(PatchSpec(**EDGE), method=method, packed=packed, threshold=90)
    got = apply_ingress(spec, torch.from_numpy(raw))
    got = words_to_uint32(got) if packed else got.numpy()
    np.testing.assert_array_equal(np.asarray(want), got)


def test_apply_ingress_multichannel_none_matches_reference():
    kw = dict(image_x=6, image_y=6, window_x=3, window_y=3, channels=2)
    raw = (np.random.default_rng(8).random((2, 6, 6, 2)) > 0.5).astype(np.uint8)
    want = j_apply_ingress(JIngressSpec(JPatchSpec(**kw), method="none"), jnp.asarray(raw))
    spec = IngressSpec(PatchSpec(**kw), method="none")
    assert raw_trailing_shape(spec) == (6, 6, 2)
    np.testing.assert_array_equal(np.asarray(want),
                                  words_to_uint32(apply_ingress(spec, torch.from_numpy(raw))))


def test_ingress_spec_refuses_unported_methods():
    """Every method of the reference is ported now; a method outside its
    set is refused by both packages."""
    for spec_cls, patch in ((IngressSpec, PatchSpec()), (JIngressSpec, JPatchSpec())):
        with pytest.raises(ValueError, match="unknown booleanization method"):
            spec_cls(patch, method="otsu")
    assert IngressSpec(PatchSpec(), method="adaptive_gaussian").resolved_method == "adaptive"


def test_class_sums_and_argmax_match_reference():
    rng = np.random.default_rng(9)
    fired = (rng.random((6, 40)) > 0.5).astype(np.uint8)
    w = rng.integers(-127, 128, (10, 40)).astype(np.int32)
    want = np.asarray(jcl.class_sums(jnp.asarray(fired), jnp.asarray(w)))
    got = tcl.class_sums(torch.from_numpy(fired), torch.from_numpy(w))
    np.testing.assert_array_equal(want, got.numpy())
    ties = np.array([[3, 3, 1], [0, 0, 0], [-1, 2, 2]], np.int32)
    np.testing.assert_array_equal(np.asarray(jcl.argmax_predict(jnp.asarray(ties))),
                                  tcl.argmax_predict(torch.from_numpy(ties)).numpy())
    assert tcl.argmax_predict(torch.from_numpy(ties)).tolist() == [0, 0, 1]


def test_matmul_path_clause_eval_matches_dense():
    rng = np.random.default_rng(10)
    lits = torch.from_numpy((rng.random((3, 20, 64)) > 0.3).astype(np.uint8))
    inc = torch.from_numpy((rng.random((30, 64)) > 0.95).astype(np.uint8))
    inc[0] = 0
    dense = tcl.eval_clauses_dense(lits, inc)
    assert torch.equal(tcl.eval_clauses_matmul(lits, inc), dense)
    from repro_torch.core.patches import pack_bits
    assert torch.equal(
        tcl.eval_clauses_bitpacked(pack_bits(lits), pack_bits(inc), tcl.clause_nonempty(inc)),
        dense)
    assert dense.any() and not dense[:, 0].any()


@pytest.fixture(scope="module")
def paper_engines():
    """JAX and port engines, max_batch=8, serving the same boundary model of
    the paper configuration on the fused path, plus a few-include pool;
    each also under ``<model>/<path>`` on the kernel and sparse paths."""
    jm, jcfg, tm, tcfg = _models({}, 128, seed=0)
    jf, tf = _few_includes(jm, tm, seed=11)
    je = JServingEngine(max_batch=8)
    te = ServingEngine(max_batch=8, device="cpu")
    for name, (jmod, tmod) in {"boundary": (jm, tm), "few": (jf, tf)}.items():
        je.register(name, jmod, jcfg, path="fused")
        te.register(name, tmod, tcfg, path="fused")
        for path in NEW_PATHS:
            je.register(f"{name}/{path}", jmod, jcfg, path=path)
            te.register(f"{name}/{path}", tmod, tcfg, path=path)
    return je, te


@pytest.mark.parametrize("model", ["boundary", "few"])
@pytest.mark.parametrize("n", [1, 5, 9])
def test_engine_classify_matches_reference(paper_engines, n, model):
    je, te = paper_engines
    raw = _raw(n, 28, 28, seed=n)
    want, got = je.classify(model, raw), te.classify(model, raw)
    np.testing.assert_array_equal(want.predictions, got.predictions)
    np.testing.assert_array_equal(want.class_sums, got.class_sums)
    assert got.predictions.dtype == np.int32 and got.class_sums.shape == (n, 10)
    assert got.bucket == {1: 1, 5: 8, 9: 8}[n]


@pytest.mark.parametrize("model", ["boundary", "few"])
@pytest.mark.parametrize("path", NEW_PATHS)
def test_engine_new_paths_match_reference(paper_engines, path, model):
    je, te = paper_engines
    name = f"{model}/{path}"
    assert te.resolved_path(name) == path
    raw = _raw(5, 28, 28, seed=20)
    want, got = je.classify(name, raw), te.classify(name, raw)
    np.testing.assert_array_equal(want.predictions, got.predictions)
    np.testing.assert_array_equal(want.class_sums, got.class_sums)
    assert got.bucket == 8
    if model == "few":
        assert got.class_sums.any()


def test_resolved_path_names_the_path_that_runs():
    jm, jcfg, tm, tcfg = _models(EDGE, 37, seed=6)
    te = ServingEngine(max_batch=4, device="cpu")
    for path in PATHS:
        te.register(path, tm, tcfg, path=path)
        assert te.resolved_path(path) == path
    # A servable carrying no sparsity image (as registered by a caller that
    # bypasses the analysis) resolves each sparse path to its dense twin.
    bare = freeze(tm, tcfg)
    for path in ("sparse", "fused_sparse", "matmul_sparse"):
        te._servables[path].servable = bare
        assert te.resolved_path(path) == tpaths.get_path(path).fallback
        raw = _raw(3, 11, 11, seed=21)
        np.testing.assert_array_equal(te.classify(path, raw).class_sums,
                                      te.classify("dense", raw).class_sums)


def test_engine_buckets_stats_and_validation():
    jm, jcfg, tm, tcfg = _models(EDGE, 37, seed=3)
    te = ServingEngine(max_batch=8, device="cpu")
    te.register("m", tm, tcfg, path="fused")
    assert [te.bucket_for(n) for n in (1, 2, 3, 5, 8, 9, 100)] == [1, 2, 4, 8, 8, 8, 8]
    assert te.warmup("m") == (1, 2, 4, 8)
    assert te.stats("m").requests == 0
    res = te.dispatch("m", _raw(11, 11, 11, seed=1)).result()
    assert res.bucket == 8 and res.predictions.shape == (11,)
    st = te.stats("m")
    assert (st.requests, st.images, st.bucket_hits) == (1, 11, {8: 1, 4: 1})
    assert st.classifications_per_s > 0 and "mean_latency_us" in st.as_dict()
    with pytest.raises(ValueError, match="must be"):
        te.classify("m", _raw(2, 28, 28, seed=1))
    with pytest.raises(ValueError, match="empty"):
        te.classify("m", np.zeros((0, 11, 11), np.uint8))
    with pytest.raises(KeyError, match="unknown eval path"):
        te.register("x", tm, tcfg, path="no_such_path")


def test_register_leaves_a_given_servable_in_place():
    _, _, tm, tcfg = _models(EDGE, 37, seed=5)
    sm = freeze(tm, tcfg)
    placed = ServingEngine(max_batch=4, device="meta").register("m", sm, path="fused")
    assert placed.include.device.type == "meta" and sm.include.device.type == "cpu"


def test_engine_without_cuda_raises(monkeypatch):
    """No device given and no CUDA: the engine refuses to start instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(device="cuda")


def test_port_init_is_seeded_and_in_range():
    cfg = COTM_CONFIGS["convcotm-mnist"]
    a = init_boundary_model(prng_key(3), cfg)
    b = init_boundary_model(prng_key(3), cfg)
    assert torch.equal(a.ta_state, b.ta_state) and torch.equal(a.weights, b.weights)
    assert a.ta_state.shape == (128, 272) and a.ta_state.dtype == torch.uint8
    assert int(a.ta_state.min()) >= 118 and int(a.ta_state.max()) < 138
    assert set(a.weights.unique().tolist()) == {-1, 1}
    assert BOOLEANIZE_METHOD["convcotm-mnist"] == "threshold"
    with pytest.raises(ValueError, match="envelope"):
        CoTMConfig(n_clauses=2048)


def test_model_from_arrays_validates():
    with pytest.raises(ValueError, match="expected"):
        model_from_arrays(np.zeros((4, 8), np.uint8), np.zeros((2, 5), np.int32))
    with pytest.raises(TypeError, match="uint8"):
        model_from_arrays(np.zeros((4, 8), np.int32), np.zeros((2, 4), np.int32))
    w = np.asarray(jpack(jnp.ones((3, 40), jnp.uint8)))
    assert np.array_equal(words_to_uint32(words_from_uint32(w)), w)


def test_launcher_serves_on_cpu(capsys):
    stats = serve_tm("convcotm-mnist", n_requests=2, max_batch=4, device="cpu")
    assert stats["requests"] == 2 and stats["images"] >= 2
    assert "classifications/s" in capsys.readouterr().out
