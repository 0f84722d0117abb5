"""Port vs reference: the clause-sparsity image and the sparse eval paths.

The same numpy TA states and weights become a reference model and a port
model; ``analyze_sparsity`` on both sides is held field by field, and each
sparse path's class sums bit for bit against the reference's
``run_path`` (which runs the JAX oracles on the CPU).  The port runs on
the CPU, where each kernel takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import CoTMModel as JCoTMModel
from repro.core.ingress import apply_ingress as j_apply_ingress
from repro.core.patches import PatchSpec as JPatchSpec
from repro.serve import analyze_sparsity as j_analyze
from repro.serve import freeze as jfreeze
from repro.serve import paths as jpaths
from repro.serve.servable import active_pad as j_active_pad
from repro_torch.convert import model_from_arrays, words_to_uint32
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.ingress import apply_ingress
from repro_torch.core.patches import PatchSpec
from repro_torch.serve import paths as tpaths
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.servable import active_pad, analyze_sparsity, freeze

EDGE = dict(image_x=11, image_y=11, window_x=5, window_y=5)
SPARSE_PATHS = ("sparse", "fused_sparse", "matmul_sparse")
POOLS = ("boundary", "some_empty", "one_active", "all_empty")


def _ta(pool, n_clauses, n_literals, seed):
    """Seeded uint8 TA states [C, 2o] of one of the :data:`POOLS`."""
    rng = np.random.default_rng(seed)
    ta = rng.integers(118, 138, (n_clauses, n_literals), dtype=np.uint8)
    if pool == "boundary":
        return ta
    # A few includes per clause (so clauses fire), then empty clauses.
    ta = np.where(rng.random(ta.shape) < 3.0 / n_literals, 133, 123).astype(np.uint8)
    ta[:, 0] = np.maximum(ta[:, 0], 128)          # every clause nonempty so far
    if pool == "some_empty":
        ta[rng.random(n_clauses) < 0.4] = 0
    elif pool == "one_active":
        ta[1:] = 0
    else:
        ta[:] = 0
    return ta


def _pair(pool, patch_kw, n_clauses, seed=0):
    """(reference servable, port servable, reference config, port config)."""
    jcfg = JCoTMConfig(n_clauses=n_clauses, n_classes=10, patch=JPatchSpec(**patch_kw))
    tcfg = CoTMConfig(n_clauses=n_clauses, n_classes=10, patch=PatchSpec(**patch_kw))
    ta = _ta(pool, n_clauses, tcfg.n_literals, seed)
    w = np.random.default_rng(seed + 1).integers(-127, 128, (10, n_clauses)).astype(np.int32)
    jm = JCoTMModel(ta_state=jnp.asarray(ta), weights=jnp.asarray(w))
    return jfreeze(jm, jcfg), freeze(model_from_arrays(ta, w), tcfg), jcfg, tcfg


def _assert_same_sparsity(js, ts):
    jsp, tsp = js.sparsity, ts.sparsity
    assert tsp.n_active == jsp.n_active
    for field in ("active_idx", "include", "include_counts", "weights"):
        got, want = getattr(tsp, field).numpy(), np.asarray(getattr(jsp, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(want, got, err_msg=field)
    for field in ("include_packed", "exclude_packed"):
        assert getattr(tsp, field).dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(getattr(jsp, field)),
                                      words_to_uint32(getattr(tsp, field)), err_msg=field)


@pytest.mark.parametrize("pad_to", [None, "pow2", 100], ids=["unpadded", "pow2", "int"])
@pytest.mark.parametrize("pool", POOLS)
def test_analyze_sparsity_matches_reference(pool, pad_to):
    js, ts, _, _ = _pair(pool, EDGE, 77, seed=POOLS.index(pool))
    ja, ta = j_analyze(js, pad_to=pad_to), analyze_sparsity(ts, pad_to=pad_to)
    _assert_same_sparsity(ja, ta)
    n_active = int(ts.nonempty.sum())
    want_rows = {None: n_active, "pow2": active_pad(n_active, 77), 100: 100}[pad_to]
    assert ta.sparsity.n_active == want_rows
    if pool == "all_empty" and pad_to is None:
        assert ta.sparsity.include.shape == (0, ts.include.shape[1])
        assert ta.sparsity.weights.shape == (10, 0)
    # Synthetic rows: all-ones exclude words, zero weight columns, index -1.
    pad = slice(n_active, None)
    assert bool((ta.sparsity.exclude_packed[pad] == -1).all())
    assert not ta.sparsity.weights[:, pad].any()
    assert bool((ta.sparsity.active_idx[pad] == -1).all())
    # The pad bits past 2o of every exclude word are set.
    n_lit = ts.include.shape[1]
    if n_lit % 32:
        top = ta.sparsity.exclude_packed[:, -1] >> (n_lit % 32)
        assert bool((top == -1).all())           # arithmetic shift of set bits


def test_analyze_sparsity_is_idempotent_and_shares_tensors():
    _, ts, _, _ = _pair("some_empty", EDGE, 37, seed=3)
    once = analyze_sparsity(ts)
    assert analyze_sparsity(once) is once
    assert analyze_sparsity(once, pad_to="pow2") is once
    assert ts.sparsity is None and once.include is ts.include
    assert set(dict(once.named_buffers())) >= {
        "sparsity.exclude_packed", "sparsity.weights", "include", "weights"}
    with pytest.raises(ValueError, match="pad_to"):
        analyze_sparsity(ts, pad_to=1)


def test_active_pad_matches_reference():
    for n_clauses in (1, 37, 128, 1024):
        for n_active in range(0, n_clauses + 1, max(1, n_clauses // 17)):
            assert active_pad(n_active, n_clauses) == j_active_pad(n_active, n_clauses)


def _literals(path_name, jcfg, tcfg, raw):
    jp, tp_ = jpaths.get_path(path_name), tpaths.get_path(path_name)
    jl = j_apply_ingress(jp.ingress_spec(jcfg.patch), jnp.asarray(raw))
    tl = apply_ingress(tp_.ingress_spec(tcfg.patch), torch.from_numpy(raw))
    return jl, tl


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("name", SPARSE_PATHS)
def test_sparse_run_path_matches_reference(name, pool):
    js, ts, jcfg, tcfg = _pair(pool, EDGE, 37, seed=5)
    js, ts = j_analyze(js), analyze_sparsity(ts)
    raw = np.random.default_rng(6).integers(0, 256, (5, 11, 11), dtype=np.uint8)
    jl, tl = _literals(name, jcfg, tcfg, raw)
    want = np.asarray(jpaths.run_path(jpaths.get_path(name), js, jl))
    got = tpaths.run_path(tpaths.get_path(name), ts, tl)
    assert got.dtype == torch.int32 and tpaths.resolve_path(tpaths.get_path(name), ts).name == name
    np.testing.assert_array_equal(want, got.numpy())
    if pool in ("some_empty", "one_active"):
        assert want.any()
    if pool == "all_empty":
        assert not want.any()


@pytest.mark.parametrize("name", SPARSE_PATHS)
def test_sparse_paths_at_paper_geometry_with_padding(name):
    """The paper's geometry, a pool with empty clauses, the unpadded and
    the pow2-padded image: both equal the reference."""
    js, ts, jcfg, tcfg = _pair("some_empty", {}, 128, seed=7)
    raw = np.random.default_rng(8).integers(0, 256, (3, 28, 28), dtype=np.uint8)
    jl, tl = _literals(name, jcfg, tcfg, raw)
    want = np.asarray(jpaths.run_path(jpaths.get_path(name), j_analyze(js), jl))
    for pad_to in (None, "pow2"):
        sm = analyze_sparsity(ts, pad_to=pad_to)
        got = tpaths.run_path(tpaths.get_path(name), sm, tl)
        np.testing.assert_array_equal(want, got.numpy())
    assert want.any()


@pytest.mark.parametrize("name", SPARSE_PATHS)
def test_no_sparsity_runs_the_dense_twin(name):
    js, ts, jcfg, tcfg = _pair("some_empty", EDGE, 37, seed=9)
    path = tpaths.get_path(name)
    assert ts.sparsity is None
    assert tpaths.resolve_path(path, ts).name == path.fallback == jpaths.get_path(name).fallback
    assert tpaths.get_path(path.fallback).input_form == path.input_form
    raw = np.random.default_rng(10).integers(0, 256, (4, 11, 11), dtype=np.uint8)
    jl, tl = _literals(name, jcfg, tcfg, raw)
    want = np.asarray(jpaths.run_path(jpaths.get_path(name), js, jl))
    np.testing.assert_array_equal(want, tpaths.run_path(path, ts, tl).numpy())


@pytest.mark.parametrize("name", sorted(jpaths._DEGRADED_CHAIN))
def test_degraded_fallback_matches_reference(name):
    assert tpaths.degraded_fallback(name) == jpaths.degraded_fallback(name)
    assert tpaths._DEGRADED_CHAIN == jpaths._DEGRADED_CHAIN


def test_degraded_fallback_outside_the_chain(monkeypatch):
    """A path the chain does not name falls to its declared fallback, else
    to ``dense``, as in the reference."""
    fn = tpaths.get_path("sparse").fn
    monkeypatch.setitem(tpaths._REGISTRY, "x_sparse", tpaths.EvalPath(
        "x_sparse", tpaths.PACKED, fn, needs_sparsity=True, fallback="fused"))
    monkeypatch.setitem(tpaths._REGISTRY, "x_plain", tpaths.EvalPath("x_plain", tpaths.DENSE, fn))
    assert tpaths.degraded_fallback("x_sparse") == "fused"
    assert tpaths.degraded_fallback("x_plain") == "dense"


def test_paths_registry_matches_reference():
    assert tpaths.available_paths() == jpaths.available_paths()
    for name in tpaths.available_paths():
        jp, tp_ = jpaths.get_path(name), tpaths.get_path(name)
        assert (tp_.input_form, tp_.needs_sparsity, tp_.fallback) == (
            jp.input_form, jp.needs_sparsity, jp.fallback)
    with pytest.raises(ValueError, match="fallback"):
        tpaths.EvalPath("x", tpaths.PACKED, fn=lambda *a: None, needs_sparsity=True)


def test_engine_register_attaches_sparsity():
    _, ts, _, tcfg = _pair("some_empty", EDGE, 37, seed=11)
    te = ServingEngine(max_batch=4, device="cpu")
    placed = te.register("m", ts, path="sparse")
    assert placed.sparsity is not None and ts.sparsity is None
    assert placed.sparsity.n_active == int(ts.nonempty.sum()) < 37
    assert te.resolved_path("m") == "sparse"
