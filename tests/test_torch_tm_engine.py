"""Port vs reference: the TrainerEngine, its launcher and the train -> serve
hand-off.

The reference engine draws each step's key from its ``_chain_keys``
chain (``key, k = split(key)``) and each sample's from ``split(k, B)``.
The port's engine takes a key too and walks the same chain, so from one
seed both engines (and both launchers, and a checkpoint moved between
them) must end with ``array_equal`` models, unless a patch choice is
decided by the last place of the Gumbel noise's logs
(:func:`assert_same_or_explained` then shows that it was).  Tests of the
engine's mechanics feed it the reference's exported draws
(``chain_draws``), a quicker source; with draws of its own (a test-side
``torch.Generator``) the two trainers are compared for accuracy on the
same glyph split instead.
"""

import gzip
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.convcotm import COTM_CONFIGS as J_CONFIGS
from repro.core import train as jt
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import init_model as j_init_model
from repro.core.patches import PatchSpec as JPatchSpec
from repro.data import PipelineState as JPipelineState
from repro.data import batches as j_batches
from repro.data import datasets as j_datasets
from repro.data import synthetic_glyphs as j_glyphs
from repro.launch.train import run_tm_training as j_run_tm_training
from repro.train.tm_engine import TrainerEngine as JTrainerEngine
from repro_torch.checkpoint.checkpointer import latest_step, restore_pytree
from repro_torch.configs.convcotm import COTM_CONFIGS
from repro_torch.convert import draws_from_arrays, model_from_arrays, model_to_arrays
from repro_torch.core import prng
from repro_torch.core import train as tt
from repro_torch.core.cotm import CoTMConfig, init_model
from repro_torch.core.patches import PatchSpec
from repro_torch.core.prng import prng_key
from repro_torch.core.train import TrainDraws
from repro_torch.data import DoubleBufferedLoader, PipelineState, batches, synthetic_glyphs
from repro_torch.data import datasets as t_datasets
from repro_torch.data.pipeline import epoch_permutation
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import run_tm_training
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.tm_engine import TrainerEngine
from test_torch_prng import assert_gumbel_close, one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

PATCH = dict(image_x=8, image_y=8, window_x=3, window_y=3)


def _cfgs(**kw):
    base = dict(n_clauses=16, n_classes=3, T=15, s=3.0)
    base.update(kw)
    return (JCoTMConfig(patch=JPatchSpec(**PATCH), **base),
            CoTMConfig(patch=PatchSpec(**PATCH), **base))


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 8, 8)) > 0.5).astype(np.uint8),
            rng.integers(0, 3, n).astype(np.int32))


def _sample_draws(key, cfg):
    k_patch, k_neg, k_t, k_q, k_ia1, k_ia0, k_ib = jax.random.split(key, 7)
    p, c, n, m = cfg.patch.n_patches, cfg.n_clauses, cfg.n_literals, cfg.n_classes
    return (jax.random.gumbel(k_patch, (p, c)),
            jax.random.randint(k_neg, (), 0, m - 1, jnp.int32),
            jax.random.uniform(k_t, (c,)), jax.random.uniform(k_q, (c,)),
            jax.random.uniform(k_ia1, (c, n)), jax.random.uniform(k_ia0, (c, n)),
            jax.random.uniform(k_ib, (c, n)))


def chain_draws(key, steps, b, cfg):
    """The reference engine's draws for ``steps`` steps from ``key``:
    (advanced key, one TrainDraws per step)."""
    key, keys = JTrainerEngine._chain_keys(key, steps)
    per_step = jax.jit(jax.vmap(lambda k: jax.vmap(lambda s: _sample_draws(s, cfg))(
        jax.random.split(k, b))))(keys)
    arrs = [np.asarray(a) for a in per_step]
    return key, [draws_from_arrays(*[a[s] for a in arrs]) for s in range(steps)]


def _same_model(tm, jm):
    ta, w = model_to_arrays(tm)
    np.testing.assert_array_equal(ta, np.asarray(jm.ta_state))
    np.testing.assert_array_equal(w, np.asarray(jm.weights))


def _equal(tm, jm) -> bool:
    ta, w = model_to_arrays(tm)
    return np.array_equal(ta, np.asarray(jm.ta_state)) and np.array_equal(
        w, np.asarray(jm.weights))


def torch_draws(seed, b, cfg):
    """Draws of the port's own, from a test-side ``torch.Generator``: one
    TrainDraws per step, without end."""
    g = torch.Generator().manual_seed(seed)
    p, c, n, m = cfg.patch.n_patches, cfg.n_clauses, cfg.n_literals, cfg.n_classes
    while True:
        u = torch.rand((b, p, c), generator=g).clamp_(min=torch.finfo(torch.float32).tiny)
        yield TrainDraws(gumbel=-torch.log(-torch.log(u)),
                         neg=torch.randint(0, m - 1, (b,), generator=g),
                         u_t=torch.rand((b, c), generator=g), u_q=torch.rand((b, c), generator=g),
                         **{k: torch.rand((b, c, n), generator=g)
                            for k in ("u_ia1", "u_ia0", "u_ib")})


def assert_same_or_explained(jcfg, tcfg, key_seed, literals, labels, steps_idx, m0):
    """Replay a run step by step from ``prng_key(key_seed)`` in both
    packages (batch mode, the engine's ``key, k = split(key)`` chain over
    the step index rows ``steps_idx``), from the port model ``m0``.  Every
    step's models are equal, or at the first step where they part some
    fired clause chose another patch, and at each such choice the two
    packages' top scores lie within their Gumbel noise's last places
    (:func:`assert_gumbel_close`'s bound at both patches)."""
    tm = m0
    jm = jt.CoTMModel(ta_state=jnp.asarray(m0.ta_state.numpy()),
                      weights=jnp.asarray(m0.weights.numpy()))
    tkey, jkey = prng_key(key_seed), jax.random.PRNGKey(key_seed)
    tiny = np.finfo(np.float32).tiny
    for ix in steps_idx:
        tkey, tk = prng.split(tkey).unbind(0)
        jkey, jk = jax.random.split(jkey)
        lits, y = literals[ix], labels[ix]
        draws = tt.make_draws(tk, len(ix), tcfg)
        want = chain_draws_one(jk, len(ix), jcfg)
        nxt_t = tt.update_batch_literals(draws, tm, torch.from_numpy(lits),
                                         torch.from_numpy(y), tcfg)
        nxt_j = jt.update_batch_literals(jk, jm, jnp.asarray(lits), jnp.asarray(y), jcfg)
        if _equal(nxt_t, nxt_j):
            tm, jm = nxt_t, nxt_j
            continue
        cp = tt._train_patch_outputs(torch.from_numpy(lits), tm.include, tcfg) > 0
        fired = cp.any(dim=1)                                        # [B, C]
        g_t, g_j = draws.gumbel, want.gumbel
        pick_t = torch.where(cp, g_t, -np.inf).argmax(dim=1)
        pick_j = torch.where(cp, g_j, -np.inf).argmax(dim=1)
        parted = (pick_t != pick_j) & fired
        assert parted.any(), "the models part with every patch choice equal"
        k_patch = prng.split(prng.split(tk, len(ix)), 7)[:, 0]
        u = prng.uniform(k_patch, tuple(g_t.shape[1:]), minval=tiny)
        for b, c in parted.nonzero().tolist():
            p1, p2 = int(pick_t[b, c]), int(pick_j[b, c])
            for p in (p1, p2):
                assert_gumbel_close(g_t[b, p, c:c + 1].numpy(), g_j[b, p, c:c + 1].numpy(),
                                    u[b, p, c:c + 1].numpy())
        return
    raise AssertionError("the replayed runs never part, but the compared runs did")


def chain_draws_one(k, b, cfg):
    """One step's draws of the reference from its step key ``k``."""
    arrs = jax.vmap(lambda s: _sample_draws(s, cfg))(jax.random.split(k, b))
    return draws_from_arrays(*[np.asarray(a) for a in arrs])


@pytest.mark.parametrize("mode", ["batch", "scan"])
def test_fit_matches_reference_engine(mode):
    jcfg, tcfg = _cfgs()
    x, y = _data()
    key = jax.random.PRNGKey(3)
    jeng = JTrainerEngine(jcfg, batch_size=16, mode=mode)
    jds = jeng.prepare(x, y, booleanize_method="none")
    jm0 = jeng.init_model(key)
    tm0 = model_from_arrays(jm0.ta_state, jm0.weights)    # before jm0 is donated
    _, jm, jstate, _ = jeng.fit(key, jm0, jds, epochs=2, state=JPipelineState(seed=5))

    eng = TrainerEngine(tcfg, batch_size=16, mode=mode, device="cpu")
    ds = eng.prepare(x, y, booleanize_method="none")
    np.testing.assert_array_equal(ds.literals.numpy(), np.asarray(jds.literals))
    np.testing.assert_array_equal(ds.labels.numpy(), np.asarray(jds.labels))
    _, draws = chain_draws(key, 8, 16, jcfg)
    source, tm, state, reports = eng.fit(iter(draws), tm0, ds, epochs=2, eval_ds=ds,
                                         state=PipelineState(seed=5))
    _same_model(tm, jm)
    assert state.as_dict() == dataclasses_asdict(jstate)
    assert [r.epoch for r in reports] == [0, 1] and reports[-1].samples == 64
    assert reports[-1].accuracy == jeng.evaluate(jm, jds)
    assert next(source, None) is None                    # one draw per step, all used


def dataclasses_asdict(state):
    return {"epoch": state.epoch, "step": state.step, "seed": state.seed}


def test_resume_mid_epoch_and_rollover_match_reference():
    jcfg, tcfg = _cfgs()
    x, y = _data(n=48, seed=1)
    key = jax.random.PRNGKey(8)
    jeng = JTrainerEngine(jcfg, batch_size=16)
    jds = jeng.prepare(x, y, booleanize_method="none")
    eng = TrainerEngine(tcfg, batch_size=16, device="cpu")
    ds = eng.prepare(x, y, booleanize_method="none")
    jm0 = j_init_model(key, jcfg)
    tm0 = model_from_arrays(jm0.ta_state, jm0.weights)
    # Mid-epoch cursor: the rest of epoch 2 (steps 1 and 2 of 3).  The
    # reference's epoch donates its model: each run gets a fresh one.
    mid = (2, 1, 4)
    jk, jm, jst, jn = jeng.run_epoch(key, j_init_model(key, jcfg), jds, JPipelineState(*mid))
    _, draws = chain_draws(key, 2, 16, jcfg)
    _, tm, st, n = eng.run_epoch(iter(draws), tm0, ds, PipelineState(*mid))
    _same_model(tm, jm)
    assert (st.as_dict(), n) == (dataclasses_asdict(jst), jn) == ({"epoch": 3, "step": 0,
                                                                  "seed": 4}, 32)
    # A cursor past the epoch's last step trains the next epoch, whole.
    jk, jm, jst, jn = jeng.run_epoch(key, j_init_model(key, jcfg), jds,
                                     JPipelineState(0, 3, 4))
    _, draws = chain_draws(key, 3, 16, jcfg)
    _, tm, st, n = eng.run_epoch(iter(draws), tm0, ds, PipelineState(0, 3, 4))
    _same_model(tm, jm)
    assert (st.epoch, st.step, n) == (jst.epoch, jst.step, jn) == (2, 0, 48)
    # The engine walks the order batches() yields from the same cursor.
    order = [yb for _, yb, _ in batches(x, y, 16, PipelineState(2, 1, 4))]
    perm_labels = [ds.labels.numpy()[i] for i in
                   np.random.default_rng(np.random.SeedSequence([4, 2])).permutation(48)[16:]]
    np.testing.assert_array_equal(np.concatenate(order), perm_labels)


def test_evaluate_predict_and_freeze_servable_match_reference():
    jcfg, tcfg = _cfgs(n_clauses=24)
    x, y = _data(n=40, seed=2)
    key = jax.random.PRNGKey(0)
    jeng = JTrainerEngine(jcfg, batch_size=8, eval_batch=7)
    jds = jeng.prepare(x, y, booleanize_method="none")
    _, jm, jst, _ = jeng.fit(key, j_init_model(key, jcfg), jds, epochs=1)
    eng = TrainerEngine(tcfg, batch_size=8, eval_batch=7, device="cpu")
    ds = eng.prepare(x, y, booleanize_method="none")
    tm = model_from_arrays(jm.ta_state, jm.weights)
    assert tm.include.any()
    assert eng.evaluate(tm, ds) == jeng.evaluate(jm, jds)
    js = jeng.freeze_servable(jm, JPipelineState(3, 2, 0))
    ts = eng.freeze_servable(tm, PipelineState(3, 2, 0))
    assert ts.version.as_dict() == js.version.as_dict()
    assert ts.version.digest and ts.version.epoch == 3
    # The frozen model served on fused gives evaluate's predictions.
    serve = ServingEngine(max_batch=16, device="cpu")
    serve.register("m", ts, path="fused", booleanize_method="none")
    assert serve.version("m").digest == ts.version.digest
    assert serve.version("m").version == 1
    res = serve.classify("m", x)
    np.testing.assert_array_equal(res.predictions, eng.predict(tm, ds).numpy())


@pytest.mark.parametrize("data", [2, 4])
def test_meshed_fit_matches_unmeshed_reference_engine(data):
    """Data-parallel batch mode on a mesh of ``data`` CPU shards: each
    shard computes its rows' deltas, the int32 sums meet exactly, and the
    model equals the unmeshed reference trainer's from the same draws."""
    jcfg, tcfg = _cfgs()
    x, y = _data()
    key = jax.random.PRNGKey(3)
    jeng = JTrainerEngine(jcfg, batch_size=16)
    jds = jeng.prepare(x, y, booleanize_method="none")
    jm0 = jeng.init_model(key)
    tm0 = model_from_arrays(jm0.ta_state, jm0.weights)
    _, jm, jstate, _ = jeng.fit(key, jm0, jds, epochs=2, state=JPipelineState(seed=5))

    eng = TrainerEngine(tcfg, batch_size=16, mesh=make_test_mesh(data, 1))
    assert eng.device == torch.device("cpu") and eng.mesh.shape == {"data": data, "model": 1}
    ds = eng.prepare(x, y, booleanize_method="none")
    _, draws = chain_draws(key, 8, 16, jcfg)
    _, tm, state, reports = eng.fit(iter(draws), tm0, ds, epochs=2, eval_ds=ds,
                                    state=PipelineState(seed=5))
    _same_model(tm, jm)
    assert state.as_dict() == dataclasses_asdict(jstate)
    assert reports[-1].accuracy == jeng.evaluate(jm, jds)


def test_engine_refuses_mesh_bad_mode_and_small_datasets():
    _, tcfg = _cfgs()
    with pytest.raises(TypeError, match="mesh"):
        TrainerEngine(tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mode='scan'"):
        TrainerEngine(tcfg, mode="scan", mesh=make_test_mesh(2, 1))
    with pytest.raises(ValueError, match="batch_size=10 must divide"):
        TrainerEngine(tcfg, batch_size=10, mesh=make_test_mesh(4, 1))
    with pytest.raises(ValueError, match="data_axis 'pod'"):
        TrainerEngine(tcfg, mesh=make_test_mesh(2, 1), data_axis="pod")
    with pytest.raises(ValueError, match="unknown mode"):
        TrainerEngine(tcfg, mode="async", device="cpu")
    eng = TrainerEngine(tcfg, batch_size=100, device="cpu")
    ds = eng.prepare(*_data(n=10), booleanize_method="none")
    with pytest.raises(ValueError, match="batch_size"):
        eng.run_epoch(prng_key(0), eng.init_model(prng_key(0)), ds)


def test_glyph_accuracy_parity_with_own_generator():
    """Both trainers, each with its own random numbers (the port's from a
    test-side ``torch.Generator``), on one glyph split and config (the paper's 10x10 window at stride 2, 64 clauses): the
    port's accuracy, averaged over the last three of eight epochs (single
    epochs swing by several points), is within 5 points of the
    reference's."""
    patch = dict(image_x=28, image_y=28, window_x=10, window_y=10, stride_x=2, stride_y=2)
    kw = dict(n_clauses=64, n_classes=10, T=30, s=4.0)
    jcfg = JCoTMConfig(patch=JPatchSpec(**patch), **kw)
    tcfg = CoTMConfig(patch=PatchSpec(**patch), **kw)
    tx, ty, vx, vy = synthetic_glyphs(n_train=1000, n_test=400, seed=1)
    np.testing.assert_array_equal(tx, j_glyphs(n_train=1000, n_test=400, seed=1)[0])
    jeng = JTrainerEngine(jcfg, batch_size=25)
    key = jax.random.PRNGKey(0)
    _, _, _, jrep = jeng.fit(key, jeng.init_model(key), jeng.prepare(tx, ty), epochs=8,
                             eval_ds=jeng.prepare(vx, vy))
    eng = TrainerEngine(tcfg, batch_size=25, device="cpu")
    m0 = init_model(prng_key(0), tcfg)
    _, _, _, rep = eng.fit(torch_draws(0, 25, tcfg), m0, eng.prepare(tx, ty), epochs=8,
                           eval_ds=eng.prepare(vx, vy))
    acc = np.mean([r.accuracy for r in rep[-3:]])
    jacc = np.mean([r.accuracy for r in jrep[-3:]])
    assert jacc > 0.8, jacc                               # the task is learnt at all
    assert abs(acc - jacc) <= 0.05, (acc, jacc)


def test_launcher_trains_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    kw = dict(n_train=200, n_test=100, batch=50, device="cpu", ckpt_dir=str(tmp_path))
    one = run_tm_training("convcotm-mnist", epochs=1, **kw)
    two = run_tm_training("convcotm-mnist", epochs=2, **kw)
    assert (one["epochs"], two["epochs"]) == (1.0, 2.0)
    whole = run_tm_training("convcotm-mnist", epochs=2,
                            **{**kw, "ckpt_dir": str(tmp_path / "whole")})
    # The resumed run ends where an uninterrupted run ends.
    assert two["accuracy"] == whole["accuracy"]
    assert "resumed from epoch 1" in capsys.readouterr().out
    with pytest.raises(ValueError, match="draw sequence"):
        run_tm_training("convcotm-mnist", epochs=3, **{**kw, "batch": 40})
    done = run_tm_training("convcotm-mnist", epochs=2, **kw)
    assert done["samples_per_s"] == 0.0 and done["accuracy"] == two["accuracy"]


def _trained(ckpt_dir):
    """The model of the newest checkpoint in ``ckpt_dir`` (either
    package's), with its key and cursor."""
    template = init_model(prng_key(0), COTM_CONFIGS["convcotm-mnist"])
    model, step, extra = restore_pytree(template, str(ckpt_dir), device="cpu")
    return model, step, extra


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tm_resume_across_packages(tmp_path, writer):
    """A checkpoint written after one epoch by one package resumes in the
    other: the key (``extra["key"]``, the reference's ``uint32[2]``) and
    the cursor carry the run on, and epoch 2 ends where an uninterrupted
    two-epoch run of the resuming package ends."""
    kw = dict(n_train=100, n_test=50, batch=50)
    port = lambda epochs, d: run_tm_training("convcotm-mnist", epochs=epochs, device="cpu",
                                             ckpt_dir=str(d), **kw)
    ref = lambda epochs, d: j_run_tm_training("convcotm-mnist", epochs=epochs,
                                              ckpt_dir=str(d), **kw)
    first, second = (ref, port) if writer == "reference" else (port, ref)
    first(1, tmp_path / "run")
    one, _, extra = _trained(tmp_path / "run")
    assert np.asarray(extra["key"]).dtype.kind in "iu" and len(extra["key"]) == 2
    resumed = second(2, tmp_path / "run")
    whole = second(2, tmp_path / "whole")
    got, step, extra_got = _trained(tmp_path / "run")
    want, _, extra_want = _trained(tmp_path / "whole")
    assert step == 2 and extra_got["key"] == extra_want["key"]
    assert extra_got["pipeline"] == extra_want["pipeline"]
    np.testing.assert_array_equal(got.ta_state.numpy(), want.ta_state.numpy())
    np.testing.assert_array_equal(got.weights.numpy(), want.weights.numpy())
    assert resumed["accuracy"] == whole["accuracy"]
    assert not torch.equal(got.ta_state, one.ta_state)


def test_launcher_epoch_equals_the_references_from_one_seed(tmp_path):
    """``run_tm_training`` for one epoch at the paper's width (P=361,
    2o=272, C=128; 2 steps of 50) in both packages from one seed: the
    same key, and the same model and accuracy."""
    kw = dict(epochs=1, n_train=100, n_test=50, batch=50, seed=3)
    got = run_tm_training("convcotm-mnist", device="cpu", ckpt_dir=str(tmp_path / "t"), **kw)
    want = j_run_tm_training("convcotm-mnist", ckpt_dir=str(tmp_path / "j"), **kw)
    tm, _, textra = _trained(tmp_path / "t")
    jm, _, jextra = _trained(tmp_path / "j")
    assert textra["key"] == jextra["key"] and textra["trainer"] == jextra["trainer"]
    if torch.equal(tm.ta_state, jm.ta_state) and torch.equal(tm.weights, jm.weights):
        assert got["accuracy"] == want["accuracy"]
        return
    cfg = COTM_CONFIGS["convcotm-mnist"]
    x, y, _, _, _ = t_datasets.get_dataset("mnist", n_train=100, n_test=50)
    ds = TrainerEngine(cfg, batch_size=50, device="cpu").prepare(x, y)
    assert_same_or_explained(J_CONFIGS["convcotm-mnist"], cfg, 3, ds.literals.numpy(),
                             ds.labels.numpy(), epoch_permutation(3, 0, 100).reshape(2, 50),
                             init_model(prng_key(3), cfg))


@pytest.mark.parametrize("steps,batch", [(2, 20), (3, 8)])
def test_fit_from_one_key_equals_the_reference_at_paper_width(steps, batch):
    """``TrainerEngine.fit`` from ``prng_key(s)`` against the reference's
    ``fit`` from ``PRNGKey(s)`` at the paper's width, batch mode: the same
    advanced key, and the same model."""
    tx, ty, _, _ = synthetic_glyphs(n_train=steps * batch, n_test=0, seed=steps)
    cfg, jcfg = COTM_CONFIGS["convcotm-mnist"], J_CONFIGS["convcotm-mnist"]
    jeng = JTrainerEngine(jcfg, batch_size=batch)
    jds = jeng.prepare(tx, ty)
    jkey, jm, _, _ = jeng.fit(jax.random.PRNGKey(steps),
                              jeng.init_model(jax.random.PRNGKey(steps)), jds, epochs=1,
                              state=JPipelineState(seed=steps))
    eng = TrainerEngine(cfg, batch_size=batch, device="cpu")
    ds = eng.prepare(tx, ty)
    m0 = eng.init_model(prng_key(steps))
    key, tm, _, _ = eng.fit(prng_key(steps), m0, ds, epochs=1, state=PipelineState(seed=steps))
    np.testing.assert_array_equal(prng.key_data(key), np.asarray(jkey))
    assert (tm.ta_state != m0.ta_state).any()
    if not _equal(tm, jm):
        assert_same_or_explained(jcfg, cfg, steps, ds.literals.numpy(), ds.labels.numpy(),
                                 epoch_permutation(steps, 0, steps * batch).reshape(steps, batch),
                                 m0)


@pytest.mark.parametrize("cursor", [(0, 0, 0), (1, 2, 7), (2, 4, 3)],
                         ids=["fresh", "mid_epoch", "exhausted"])
def test_batches_and_loader_match_reference(cursor):
    x, y = _data(n=45, seed=4)
    want = list(j_batches(x, y, 10, JPipelineState(*cursor)))
    got = list(batches(x, y, 10, PipelineState(*cursor)))
    assert len(got) == len(want) > 0
    for (gx, gy, gs), (wx, wy, ws) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gs.as_dict() == dataclasses_asdict(ws)
    loaded = list(DoubleBufferedLoader(batches(x, y, 10, PipelineState(*cursor)),
                                       device="cpu"))
    assert len(loaded) == len(got)
    for (lx, ly, ls), (gx, gy, gs) in zip(loaded, got):
        assert isinstance(lx, torch.Tensor) and lx.device.type == "cpu"
        np.testing.assert_array_equal(lx.numpy(), gx)
        np.testing.assert_array_equal(ly.numpy(), gy)
        assert ls == gs


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_datasets_read_the_same_files_from_the_checkouts_data_dir(tmp_path, monkeypatch):
    """Divergence from the reference, recorded in ROADMAP section 3: the
    port's default data directory is the checkout's ``data/`` (the
    reference's is outside it), read when a dataset is loaded.  Pointed at
    the same directory, both read the same IDX files."""
    monkeypatch.delenv("REPRO_DATA_DIR", raising=False)
    assert t_datasets.data_dir() == str(Path(__file__).resolve().parents[1] / "data")
    rng = np.random.default_rng(0)
    d = tmp_path / "fmnist"
    d.mkdir()
    for split, n in (("train", 6), ("t10k", 4)):
        _write_idx(d / f"{split}-images-idx3-ubyte.gz", rng.integers(0, 256, (n, 28, 28)))
        _write_idx(d / f"{split}-labels-idx1-ubyte.gz", rng.integers(0, 10, n))
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(j_datasets, "DATA_DIR", str(tmp_path))
    got, want = t_datasets.get_dataset("fmnist"), j_datasets.get_dataset("fmnist")
    assert got[-1] == want[-1] == "real"
    assert [a.shape for a in got[:4]] == [(6, 28, 28), (6,), (4, 28, 28), (4,)]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert t_datasets.get_dataset("kmnist")[-1] == j_datasets.get_dataset("kmnist")[-1] == "synthetic"
