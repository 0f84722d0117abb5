"""Port vs reference: the register image, ``infer``/``infer_packed``,
composites, the configurations, the servable digest, and the serving
engine's request forms (raw on the device, ``ingress='host'``,
``preprocessed=True``) with booleanize knobs.  Every output is held with
``array_equal`` (bytes and strings with ``==``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import convcotm as jconfigs
from repro.core import model_io as jio
from repro.core.composites import CompositeModel as JCompositeModel
from repro.core.composites import composite_infer as j_composite_infer
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import infer as j_infer
from repro.core.cotm import infer_packed as j_infer_packed
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.core.patches import PatchSpec as JPatchSpec
from repro.core.patches import pack_bits as j_pack
from repro.core.train import batch_literals as j_batch_literals
from repro.serve import ServingEngine as JServingEngine
from repro.serve import freeze as jfreeze
from repro.serve.servable import servable_digest as j_digest
from repro_torch.configs import convcotm as tconfigs
from repro_torch.convert import model_from_arrays, model_to_arrays, words_from_uint32
from repro_torch.core import model_io as tio
from repro_torch.core.composites import CompositeModel, composite_infer
from repro_torch.core.cotm import CoTMConfig, infer, infer_packed
from repro_torch.core.patches import PatchSpec
from repro_torch.data.pipeline import preprocess_for_serving
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.servable import freeze, servable_digest

SMALL = dict(image_x=10, image_y=10, window_x=4, window_y=4)


def _few(jm, seed, per_clause=3.0):
    """A reference model with a few includes per clause (clauses fire) and
    its port copy."""
    ta = np.asarray(jm.ta_state)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random(ta.shape) < per_clause / ta.shape[1], 133, 123).astype(np.uint8)
    jm = dataclasses.replace(jm, ta_state=jnp.asarray(ta))
    return jm, model_from_arrays(ta, np.asarray(jm.weights))


def _pair(patch_kw=SMALL, n_clauses=20, seed=0, **kw):
    jcfg = JCoTMConfig(n_clauses=n_clauses, patch=JPatchSpec(**patch_kw), **kw)
    tcfg = CoTMConfig(n_clauses=n_clauses, patch=PatchSpec(**patch_kw), **kw)
    jm, tm = _few(j_init_boundary(jax.random.PRNGKey(seed), jcfg), seed)
    return jm, jcfg, tm, tcfg


def test_configs_and_reprs_match_reference():
    for name in ("convcotm-mnist", "convcotm-fmnist", "convcotm-kmnist"):
        assert repr(tconfigs.COTM_CONFIGS[name]) == repr(jconfigs.COTM_CONFIGS[name])
        assert tconfigs.BOOLEANIZE_METHOD[name] == jconfigs.BOOLEANIZE_METHOD[name]
        assert tconfigs.COTM_CONFIGS[name].model_bits == jconfigs.COTM_CONFIGS[name].model_bits
    assert repr(tconfigs.CIFAR10_COMPOSITES).replace("repro_torch", "repro") == repr(
        jconfigs.CIFAR10_COMPOSITES)
    assert tconfigs.COTM_CONFIGS["convcotm-mnist"].model_bits == 45056


@pytest.mark.parametrize("n_clauses,patch", [(128, {}), (13, SMALL)],
                         ids=["paper", "ragged_bits"])
def test_register_image_matches_reference(n_clauses, patch):
    jm, jcfg, tm, tcfg = _pair(patch, n_clauses=n_clauses, seed=1)
    tm.weights[0, :3] = torch.tensor([-128, 127, 0], dtype=torch.int32)
    jm = dataclasses.replace(jm, weights=jnp.asarray(tm.weights.numpy()))
    blob = tio.pack_model(tm, tcfg)
    assert blob == jio.pack_model(jm, jcfg)
    assert len(blob) == tio.model_size_bytes(tcfg) == jio.model_size_bytes(jcfg)
    if not patch:
        assert len(blob) == 5632
    back = tio.unpack_model(blob, tcfg, device="cpu")
    jback = jio.unpack_model(blob, jcfg)
    ta, w = model_to_arrays(back)
    np.testing.assert_array_equal(ta, np.asarray(jback.ta_state))
    np.testing.assert_array_equal(w, np.asarray(jback.weights))
    assert tio.pack_model(back, tcfg) == blob
    with pytest.raises(ValueError, match="bytes"):
        tio.unpack_model(blob[:-1], tcfg, device="cpu")
    tm.weights[0, 0] = 200
    with pytest.raises(ValueError, match="int8"):
        tio.pack_model(tm, tcfg)


@pytest.mark.parametrize("eval_path", ["matmul", "dense", "bitpacked", "fused", "kernel"])
def test_infer_matches_reference(eval_path):
    jm, jcfg, tm, tcfg = _pair(seed=2, eval_path=eval_path)
    imgs = (np.random.default_rng(3).random((5, 10, 10)) < 0.4).astype(np.uint8)
    jp, jv = j_infer(jm, jnp.asarray(imgs), jcfg)
    tp, tv = infer(tm, torch.from_numpy(imgs), tcfg)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert np.asarray(jv).any()
    words = j_pack(j_batch_literals(jnp.asarray(imgs), jcfg))
    for use_kernel in (False, True):
        jp2, jv2 = j_infer_packed(jm, words, jcfg, use_kernel)
        tp2, tv2 = infer_packed(tm, words_from_uint32(words), tcfg, use_kernel)
        np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
        np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))


def test_composite_infer_matches_reference():
    specs = [dict(SMALL), dict(image_x=10, image_y=10, window_x=10, window_y=10),
             dict(image_x=10, image_y=10, window_x=3, window_y=3, stride_x=1, channels=2)]
    members, jmembers, cfgs, jcfgs = [], [], [], []
    for i, kw in enumerate(specs):
        jm, jcfg, tm, tcfg = _pair(kw, n_clauses=16 + i, seed=10 + i)
        members.append(tm), jmembers.append(jm), cfgs.append(tcfg), jcfgs.append(jcfg)
    rng = np.random.default_rng(4)
    views = [(rng.random((6, 10, 10)) < 0.5).astype(np.uint8),
             (rng.random((6, 10, 10)) < 0.5).astype(np.uint8),
             (rng.random((6, 10, 10, 2, 1)) < 0.5).astype(np.uint8)]
    jccfg = type(jconfigs.CIFAR10_COMPOSITES)(specialists=tuple(jcfgs))
    tccfg = type(tconfigs.CIFAR10_COMPOSITES)(specialists=tuple(cfgs))
    jp, jt = j_composite_infer(JCompositeModel(members=tuple(jmembers)),
                               [jnp.asarray(v) for v in views], jccfg)
    tp, tt = composite_infer(CompositeModel(members=tuple(members)),
                             [torch.from_numpy(v) for v in views], tccfg)
    assert tt.dtype == torch.float32 and tccfg.n_classes == 10
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    with pytest.raises(ValueError, match="one view per specialist"):
        composite_infer(CompositeModel(members=tuple(members)), views[:2], tccfg)


def test_servable_digest_matches_reference():
    jm, jcfg, tm, tcfg = _pair(seed=5)
    assert servable_digest(freeze(tm, tcfg)) == j_digest(jfreeze(jm, jcfg))
    paper_j = JCoTMConfig(max_included_literals=7, boost_true_positive=False)
    paper_t = CoTMConfig(max_included_literals=7, boost_true_positive=False)
    jm2 = j_init_boundary(jax.random.PRNGKey(6), paper_j)
    tm2 = model_from_arrays(jm2.ta_state, jm2.weights)
    assert servable_digest(freeze(tm2, paper_t)) == j_digest(jfreeze(jm2, paper_j))
    assert servable_digest(freeze(tm2, paper_t)) != servable_digest(freeze(tm2, CoTMConfig()))


@pytest.mark.parametrize("path", ["fused", "matmul", "fused_sparse"])
def test_engine_request_forms_match_reference(path):
    """fmnist's adaptive ingress with custom knobs: the raw, host and
    preprocessed forms agree with each other and with the reference."""
    jm, jcfg, tm, tcfg = _pair({}, n_clauses=32, seed=7)
    knobs = dict(block_size=7, c=3.0)
    jeng = JServingEngine(max_batch=8)
    jeng.register("f", jm, jcfg, booleanize_method="adaptive", path=path, booleanize_kw=knobs)
    eng = ServingEngine(max_batch=8, device="cpu")
    eng.register("f", tm, tcfg, booleanize_method="adaptive", path=path, booleanize_kw=knobs)
    raw = np.random.default_rng(8).integers(0, 256, (11, 28, 28), dtype=np.uint8)
    want = jeng.classify("f", raw)
    lits = eng.preprocess("f", raw)
    np.testing.assert_array_equal(lits, jeng.preprocess("f", raw))
    np.testing.assert_array_equal(lits, preprocess_for_serving(
        raw, tcfg.patch, method="adaptive", packed=path != "matmul", **knobs))
    for kw, x in ((dict(), raw), (dict(ingress="host"), raw), (dict(preprocessed=True), lits)):
        res = eng.classify("f", x, **kw)
        np.testing.assert_array_equal(res.class_sums, want.class_sums)
        np.testing.assert_array_equal(res.predictions, want.predictions)
    assert want.class_sums.any()
    assert eng.ingress_spec("f").block_size == 7 and eng.models() == ("f",)
    assert eng.version("f").digest == jeng.version("f").digest
    with pytest.raises(ValueError, match="preprocessed literals"):
        eng.classify("f", lits.astype(np.int64), preprocessed=True)
    with pytest.raises(ValueError, match="ingress"):
        eng.classify("f", raw, ingress="wire")
    eng.register("f", tm, tcfg, booleanize_method="adaptive", path=path)
    assert eng.version("f").version == 2
