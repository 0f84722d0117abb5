"""Port vs reference: the training step and its draws.

The reference draws a step's random numbers from ``jax.random`` keys:
per sample ``split(key, 7)`` (``repro/core/train.py``), a Gumbel patch
noise, the negative class, and the uniforms behind each ``bernoulli``.
The port's ``make_draws`` draws the same numbers from the same key
(``core/prng.py``): the uniforms and the negative class bit for bit, the
Gumbel noise within its logs' last places.  The step tests export the
reference's arrays (``jax_step_draws``), carry them into the port with
``repro_torch.convert.draws_from_arrays``, and hold the port's deltas and
updated models with ``array_equal``; the initial models from a key are
equal too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clauses as jcl
from repro.core import train as jt
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.core.cotm import init_model as j_init_model
from repro.core.patches import PatchSpec as JPatchSpec
from repro_torch.convert import draws_from_arrays, model_from_arrays, model_to_arrays
from repro_torch.core import clauses as tcl
from repro_torch.core import prng
from repro_torch.core import train as tt
from repro_torch.core.cotm import CoTMConfig, CoTMModel, init_boundary_model, init_model
from repro_torch.core.patches import PatchSpec
from repro_torch.core.prng import prng_key
from test_torch_prng import assert_gumbel_close, one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

PATCH = dict(image_x=8, image_y=8, window_x=3, window_y=3)


def jax_sample_draws(key, cfg):
    """One sample's draws, in the order the reference splits its key."""
    k_patch, k_neg, k_t, k_q, k_ia1, k_ia0, k_ib = jax.random.split(key, 7)
    p, c, n, m = cfg.patch.n_patches, cfg.n_clauses, cfg.n_literals, cfg.n_classes
    return (jax.random.gumbel(k_patch, (p, c)),
            jax.random.randint(k_neg, (), 0, m - 1, jnp.int32),
            jax.random.uniform(k_t, (c,)), jax.random.uniform(k_q, (c,)),
            jax.random.uniform(k_ia1, (c, n)), jax.random.uniform(k_ia0, (c, n)),
            jax.random.uniform(k_ib, (c, n)))


def jax_step_draws(key, b, cfg):
    """A step's draws: ``split(key, b)`` per-sample keys, as ``_step_literals``."""
    arrs = jax.vmap(lambda k: jax_sample_draws(k, cfg))(jax.random.split(key, b))
    return draws_from_arrays(*[np.asarray(a) for a in arrs])


def _configs(**kw):
    base = dict(n_clauses=12, n_classes=4, T=20, s=3.0)
    base.update(kw)
    return (JCoTMConfig(patch=JPatchSpec(**PATCH), **base),
            CoTMConfig(patch=PatchSpec(**PATCH), **base))


def _data(n=6, seed=0, m=4):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 8, 8)) < 0.4).astype(np.uint8),
            rng.integers(0, m, n).astype(np.int32))


def _model(jcfg, seed=1, spread=4):
    """A reference model with a few includes per clause near the action
    boundary (so clauses fire, and steps both add and drop includes), one
    empty clause, and small weights of both signs; and its port copy."""
    jm = j_init_boundary(jax.random.PRNGKey(seed), jcfg, spread=spread)
    rng = np.random.default_rng(seed)
    shape = np.asarray(jm.ta_state).shape
    inc = rng.random(shape) < 3.0 / shape[1]
    inc[0] = False
    ta = np.where(inc, rng.integers(128, 128 + spread, shape),
                  rng.integers(128 - spread, 128, shape)).astype(np.uint8)
    w = rng.integers(-3, 4, np.asarray(jm.weights).shape).astype(np.int32)
    jm = dataclasses.replace(jm, ta_state=jnp.asarray(ta), weights=jnp.asarray(w))
    return jm, model_from_arrays(ta, w)


TRAIN_KW = {
    "default": {},
    "no_boost": dict(boost_true_positive=False),
    "budget": dict(max_included_literals=3),
    "no_boost_budget_dense": dict(boost_true_positive=False, max_included_literals=5,
                                  train_eval="dense"),
    "dense": dict(train_eval="dense"),
}


@pytest.mark.parametrize("name", sorted(TRAIN_KW))
def test_sample_deltas_match_reference(name):
    jcfg, tcfg = _configs(**TRAIN_KW[name])
    jm, tm = _model(jcfg)
    imgs, labels = _data()
    key = jax.random.PRNGKey(11)
    lits = jt.batch_literals(jnp.asarray(imgs), jcfg)
    keys = jax.random.split(key, len(imgs))
    ta_want, w_want = jax.vmap(
        lambda k, lit, y: jt.sample_deltas_literals(k, jm, lit, y, jcfg)
    )(keys, lits, jnp.asarray(labels))
    draws = jax_step_draws(key, len(imgs), jcfg)
    ta_got, w_got = tt.sample_deltas_literals(
        draws, tm, tt.batch_literals(torch.from_numpy(imgs), tcfg), torch.from_numpy(labels),
        tcfg)
    assert ta_got.dtype == torch.int8 and w_got.dtype == torch.int32
    np.testing.assert_array_equal(ta_got.numpy(), np.asarray(ta_want))
    np.testing.assert_array_equal(w_got.numpy(), np.asarray(w_want))
    assert np.asarray(ta_want).any() and np.asarray(w_want).any()
    # sample_deltas (from images) is the same step.
    ta_img, w_img = tt.sample_deltas(draws, tm, torch.from_numpy(imgs),
                                     torch.from_numpy(labels), tcfg)
    assert torch.equal(ta_img, ta_got) and torch.equal(w_img, w_got)


@pytest.mark.parametrize("mode", ["batch", "scan"])
@pytest.mark.parametrize("name", ["default", "no_boost_budget_dense"])
def test_update_batch_matches_reference(mode, name):
    jcfg, tcfg = _configs(**TRAIN_KW[name])
    jm, tm = _model(jcfg, seed=2)
    key = jax.random.PRNGKey(5)
    for step in range(3):
        imgs, labels = _data(seed=10 + step)
        key, k = jax.random.split(key)
        jm = jt.update_batch(k, jm, jnp.asarray(imgs), jnp.asarray(labels), jcfg, mode)
        tm = tt.update_batch(jax_step_draws(k, len(imgs), jcfg), tm, torch.from_numpy(imgs),
                             torch.from_numpy(labels), tcfg, mode)
        ta, w = model_to_arrays(tm)
        np.testing.assert_array_equal(ta, np.asarray(jm.ta_state))
        np.testing.assert_array_equal(w, np.asarray(jm.weights))
    # Literals in, the same step.
    lits = tt.batch_literals(torch.from_numpy(imgs), tcfg)
    k = jax.random.PRNGKey(9)
    a = tt.update_batch_literals(jax_step_draws(k, len(imgs), jcfg), tm, lits,
                                 torch.from_numpy(labels), tcfg, mode)
    b = jt.update_batch_literals(k, jm, jt.batch_literals(jnp.asarray(imgs), jcfg),
                                 jnp.asarray(labels), jcfg, mode)
    np.testing.assert_array_equal(a.ta_state.numpy(), np.asarray(b.ta_state))


def test_scan_differs_from_batch_and_unknown_mode_is_refused():
    jcfg, tcfg = _configs()
    _, tm = _model(jcfg)
    imgs, labels = _data(n=8)
    draws = tt.make_draws(prng_key(3), 8, tcfg)
    args = (tm, torch.from_numpy(imgs), torch.from_numpy(labels), tcfg)
    a = tt.update_batch(draws, *args, mode="batch")
    b = tt.update_batch(draws, *args, mode="scan")
    assert not torch.equal(a.ta_state, b.ta_state)
    with pytest.raises(ValueError, match="unknown mode"):
        tt.update_batch(draws, *args, mode="async")


@pytest.mark.parametrize("kw", [{}, dict(max_included_literals=2),
                                dict(boost_true_positive=False)])
def test_dense_and_matmul_train_eval_give_the_same_deltas(kw):
    _, tcfg = _configs(**kw)
    dense = dataclasses.replace(tcfg, train_eval="dense")
    g = torch.Generator().manual_seed(0)
    tm = CoTMModel(ta_state=torch.randint(118, 138, (12, tcfg.n_literals), generator=g)
                   .to(torch.uint8), weights=torch.randint(-3, 4, (4, 12), generator=g)
                   .to(torch.int32))
    imgs, labels = _data(n=10, seed=3)
    draws = tt.make_draws(prng_key(0), 10, tcfg)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    a = tt.sample_deltas(draws, tm, x, y, tcfg)
    b = tt.sample_deltas(draws, tm, x, y, dense)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="train_eval"):
        tt.sample_deltas(draws, tm, x, y, dataclasses.replace(tcfg, train_eval="sparse"))


@pytest.mark.parametrize("training", [False, True])
def test_patch_clause_outputs_match_reference(training):
    rng = np.random.default_rng(2)
    lits = (rng.random((3, 20, 30)) < 0.8).astype(np.uint8)
    inc = (rng.random((9, 30)) < 0.08).astype(np.uint8)
    inc[0] = 0                                          # an empty clause
    for jf, tf in ((jcl.patch_clause_outputs, tcl.patch_clause_outputs),
                   (jcl.patch_clause_outputs_matmul, tcl.patch_clause_outputs_matmul)):
        want = np.asarray(jf(jnp.asarray(lits), jnp.asarray(inc), training))
        got = tf(torch.from_numpy(lits), torch.from_numpy(inc), training)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, :, 0].all() == training


def test_apply_clamps_states_and_weights():
    tm = CoTMModel(ta_state=torch.tensor([[0, 1, 254, 255, 128]], dtype=torch.uint8),
                   weights=torch.tensor([[-127, 126, 0]], dtype=torch.int32))
    out = tt._apply(tm, torch.tensor([[-1, -3, 2, 1, -1]], dtype=torch.int32),
                    torch.tensor([[-5, 7, 1]], dtype=torch.int32))
    assert out.ta_state.tolist() == [[0, 0, 255, 255, 127]]
    assert out.ta_state.dtype == torch.uint8
    assert out.weights.tolist() == [[-127, 127, 1]]
    jm = jt._apply(jt.CoTMModel(ta_state=jnp.asarray(tm.ta_state.numpy()),
                                weights=jnp.asarray(tm.weights.numpy())),
                   jnp.asarray([[-1, -3, 2, 1, -1]], jnp.int32),
                   jnp.asarray([[-5, 7, 1]], jnp.int32))
    np.testing.assert_array_equal(np.asarray(jm.ta_state), out.ta_state.numpy())
    np.testing.assert_array_equal(np.asarray(jm.weights), out.weights.numpy())


def test_make_draws_shapes_ranges_and_slicing():
    _, tcfg = _configs()
    d = tt.make_draws(prng_key(1), 5, tcfg)
    p, c, n = tcfg.patch.n_patches, tcfg.n_clauses, tcfg.n_literals
    assert d.gumbel.shape == (5, p, c) and d.gumbel.dtype == torch.float32
    assert torch.isfinite(d.gumbel).all()
    assert d.u_ia1.shape == d.u_ia0.shape == d.u_ib.shape == (5, c, n)
    assert d.u_t.shape == d.u_q.shape == (5, c)
    assert int(d.neg.min()) >= 0 and int(d.neg.max()) < tcfg.n_classes - 1
    for u in (d.u_t, d.u_q, d.u_ia1, d.u_ia0, d.u_ib):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    one = d[2]
    assert one.neg.shape == (1,) and torch.equal(one.u_ib[0], d.u_ib[2])
    again = tt.make_draws(prng_key(1), 5, tcfg)
    assert torch.equal(again.gumbel, d.gumbel)
    with pytest.raises(TypeError, match="float32"):
        draws_from_arrays(np.zeros((1, p, c)), [0], *[np.zeros((1, c), np.float32)] * 2,
                          *[np.zeros((1, c, n), np.float32)] * 3)


PAPER = dict(image_x=28, image_y=28, window_x=10, window_y=10)


def _paper_configs():
    """The paper's geometry (P=361, 2o=272, C=128, m=10) in both packages."""
    return (JCoTMConfig(patch=JPatchSpec(**PAPER)), CoTMConfig(patch=PatchSpec(**PAPER)))


@pytest.mark.parametrize("seed,batch,geometry", [(0, 6, "small"), (2**31 + 5, 1, "small"),
                                                 (7, 3, "paper")])
def test_make_draws_equal_the_references_per_sample_draws(seed, batch, geometry):
    """``make_draws(key)`` against the reference's ``split(key, B)`` then
    ``split(k, 7)`` per sample: uniforms and the negative class bit for
    bit, the Gumbel noise within its logs' last places."""
    jcfg, tcfg = _paper_configs() if geometry == "paper" else _configs()
    want = jax_step_draws(jax.random.PRNGKey(seed), batch, jcfg)
    got = tt.make_draws(prng_key(seed), batch, tcfg)
    for name in ("neg", "u_t", "u_q", "u_ia1", "u_ia0", "u_ib"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy())
    k_patch = prng.split(prng.split(prng_key(seed), batch), 7)[:, 0]
    u = prng.uniform(k_patch, (tcfg.patch.n_patches, tcfg.n_clauses),
                     minval=np.finfo(np.float32).tiny)
    assert_gumbel_close(got.gumbel.numpy(), want.gumbel.numpy(), u.numpy())


@pytest.mark.parametrize("seed", [0, 3, 2**32 + 9])
@pytest.mark.parametrize("geometry", ["small", "paper"])
def test_initial_models_equal_reference_from_a_key(seed, geometry):
    """``init_model`` (weights from ``bernoulli(key, 0.5)``) and
    ``init_boundary_model`` (``split``, then ``randint`` states) from one
    key equal the reference's."""
    jcfg, tcfg = _paper_configs() if geometry == "paper" else _configs()
    jk, tk = jax.random.PRNGKey(seed), prng_key(seed)
    pairs = [(init_model(tk, tcfg), j_init_model(jk, jcfg))]
    for spread in (10, 4):
        pairs.append((init_boundary_model(tk, tcfg, spread),
                      j_init_boundary(jk, jcfg, spread=spread)))
    for tm, jm in pairs:
        ta, w = model_to_arrays(tm)
        np.testing.assert_array_equal(ta, np.asarray(jm.ta_state))
        np.testing.assert_array_equal(w, np.asarray(jm.weights))
        assert tm.ta_state.dtype == torch.uint8 and tm.weights.dtype == torch.int32


def test_accuracy_matches_reference():
    jcfg, tcfg = _configs()
    jm, tm = _model(jcfg, seed=4, spread=12)
    imgs, labels = _data(n=20, seed=6)
    want = float(jt.accuracy(jm, jnp.asarray(imgs), jnp.asarray(labels), jcfg))
    assert tt.accuracy(tm, torch.from_numpy(imgs), torch.from_numpy(labels), tcfg) == want
