"""Port vs reference: the TrainerEngine, its launcher and the train -> serve
hand-off.

The reference engine draws each step's key from its ``_chain_keys``
chain (``key, k = split(key)``) and each sample's from ``split(k, B)``;
the tests export those draws (``chain_draws``) and feed them to the
port's engine as its draw source, so both engines must end with
``array_equal`` models.  With the port's own generator the two trainers
are compared for accuracy on the same glyph split instead.
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

from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import init_model as j_init_model
from repro.core.patches import PatchSpec as JPatchSpec
from repro.data import PipelineState as JPipelineState
from repro.data import batches as j_batches
from repro.data import datasets as j_datasets
from repro.data import synthetic_glyphs as j_glyphs
from repro.train.tm_engine import TrainerEngine as JTrainerEngine
from repro_torch.checkpoint.checkpointer import latest_step
from repro_torch.convert import draws_from_arrays, model_from_arrays, model_to_arrays
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.patches import PatchSpec
from repro_torch.data import DoubleBufferedLoader, PipelineState, batches, synthetic_glyphs
from repro_torch.data import datasets as t_datasets
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import run_tm_training
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.tm_engine import TrainerEngine

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
        eng.run_epoch(torch.Generator(), eng.init_model(torch.Generator()), ds)


def test_glyph_accuracy_parity_with_own_generator():
    """Both trainers, each with its own random numbers, on one glyph split
    and config (the paper's 10x10 window at stride 2, 64 clauses): the
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
    _, _, _, rep = eng.fit(torch.Generator().manual_seed(0),
                           eng.init_model(torch.Generator().manual_seed(0)),
                           eng.prepare(tx, ty), epochs=8, eval_ds=eng.prepare(vx, vy))
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


@pytest.mark.parametrize("saved", ["cuda", None], ids=["named_cuda", "unnamed"])
def test_launcher_refuses_a_resume_on_another_device(tmp_path, saved):
    """A checkpoint whose draw generator lived on the card (its state is 16
    bytes, a CPU generator's 5,056) is refused on the CPU before the
    generator takes its state, whether the checkpoint names the card or
    names no device."""
    kw = dict(n_train=100, n_test=50, batch=50, device="cpu", ckpt_dir=str(tmp_path))
    run_tm_training("convcotm-mnist", epochs=1, **kw)
    step = latest_step(str(tmp_path))
    manifest = tmp_path / f"step_{step:08d}" / "manifest.json"
    meta = json.loads(manifest.read_text())
    assert meta["extra"]["generator_device"] == "cpu"
    meta["extra"]["generator"] = list(range(16))
    if saved is None:
        del meta["extra"]["generator_device"]
    else:
        meta["extra"]["generator_device"] = saved
    manifest.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="resuming on cpu") as e:
        run_tm_training("convcotm-mnist", epochs=2, **kw)
    assert saved is None or "cuda" in str(e.value)


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
