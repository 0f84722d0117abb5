"""Port vs reference: checkpoints restore across packages.

Both packages write the same layout (npy leaves, a JSON manifest, an
atomic ``COMMITTED`` sentinel) with the same leaf names, so a servable
checkpoint written by either restores in the other and classifies the
same.  A tuned plan the reference writes names no device, so the port
restores it as foreign (None); the port's own plan, stamped with the
device it was measured on, rides through a restore and a re-save in both
packages.  Trainer checkpoints (``CoTMModel`` trees) cross too.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import init_boundary_model as j_init_boundary
from repro.serve import ServingEngine as JServingEngine
from repro.serve import freeze as jfreeze
from repro.serve.autotune import TunedPlan
from repro.serve.servable import ServableVersion as JServableVersion
from repro.serve.servable import servable_digest as j_digest
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.convert import model_from_arrays, model_to_arrays
from repro_torch.core import model_io as tio
from repro_torch.core.cotm import CoTMConfig, CoTMModel
from repro_torch.data import DoubleBufferedLoader
from repro_torch.serve.autotune import TunedPlan as TTunedPlan
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.servable import ServableVersion, freeze, servable_digest

#: A kernel plan of the reference's autotuner (foreign to the port).
PLAN = TunedPlan(entries=(("raw", 8, "fused", ()), ("literals", 16, "matmul", ())),
                 digest="plan-digest")
#: A plan of the port's autotuner, with the CUDA kernels' parameters.
TPLAN = TTunedPlan(entries=(("literals", 16, "kernel", (("block_c", 32),)),
                            ("raw", 8, "fused", (("block_c", 64), ("csrf", False)))),
                   digest="plan-digest")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JCoTMConfig(n_clauses=32), CoTMConfig(n_clauses=32)
    jm = j_init_boundary(jax.random.PRNGKey(0), jcfg, spread=3)
    rng = np.random.default_rng(0)
    ta = np.where(rng.random((32, jcfg.n_literals)) < 3.0 / jcfg.n_literals, 133,
                  123).astype(np.uint8)           # a few includes: clauses fire
    ta[3] = 0                                     # one empty clause
    tm = model_from_arrays(ta, jm.weights)
    jm = type(jm)(ta_state=jax.numpy.asarray(ta), weights=jm.weights)
    return jm, jcfg, tm, tcfg


def _requests():
    return np.random.default_rng(1).integers(0, 256, (9, 28, 28), dtype=np.uint8)


def test_servable_written_by_the_reference_restores_in_the_port(tmp_path, models):
    jm, jcfg, tm, tcfg = models
    js = jfreeze(jm, jcfg)
    stamp = JServableVersion(version=4, epoch=2, step=7, digest=j_digest(js))
    js = dataclasses.replace(js, version=stamp, tuned=PLAN)
    jck.save_servable(js, str(tmp_path), 3)
    # The reference's plan names no device: foreign to the port.
    ts, step = tck.restore_servable(tcfg, str(tmp_path), device="cpu")
    assert step == 3 and ts.tuned is None
    assert ts.version.as_dict() == stamp.as_dict()
    assert servable_digest(ts) == stamp.digest
    assert ts.include_packed.dtype == torch.int32
    jeng = JServingEngine(max_batch=16)
    jeng.register("m", js, path="fused")
    eng = ServingEngine(max_batch=16, device="cpu")
    eng.register("m", ts, path="fused")
    want, got = jeng.classify("m", _requests()), eng.classify("m", _requests())
    np.testing.assert_array_equal(got.class_sums, want.class_sums)
    np.testing.assert_array_equal(got.predictions, want.predictions)
    assert want.class_sums.any()
    # Re-saved by the port with its own plan: the plan, stamped for the CPU,
    # and the version stamp come back unchanged, in both packages.
    tck.save_servable(ts.replace(tuned=TPLAN), str(tmp_path / "again"), 5)
    ts2, _ = tck.restore_servable(tcfg, str(tmp_path / "again"), device="cpu")
    assert ts2.tuned == TPLAN and ts2.version == ts.version
    js2, _ = jck.restore_servable(jcfg, str(tmp_path / "again"))
    assert js2.tuned == TunedPlan.from_json(TPLAN.to_json()) and js2.version == stamp
    assert (js2.tuned.entries, js2.tuned.digest) == (TPLAN.entries, TPLAN.digest)


def test_servable_written_by_the_port_restores_in_the_reference(tmp_path, models):
    jm, jcfg, tm, tcfg = models
    ts = freeze(tm, tcfg)
    ts.version = ServableVersion(version=0, epoch=1, step=2, digest=servable_digest(ts))
    tck.save_servable(ts, str(tmp_path), 9)
    js, step = jck.restore_servable(jcfg, str(tmp_path))
    assert step == 9 and js.version.as_dict() == ts.version.as_dict()
    assert j_digest(js) == ts.version.digest
    for name in ("include", "include_packed", "nonempty", "weights"):
        want = np.asarray(getattr(jfreeze(jm, jcfg), name))
        got = np.asarray(getattr(js, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    jeng = JServingEngine(max_batch=16)
    jeng.register("m", js, path="fused")
    eng = ServingEngine(max_batch=16, device="cpu")
    eng.register("m", ts, path="fused")
    np.testing.assert_array_equal(jeng.classify("m", _requests()).class_sums,
                                  eng.classify("m", _requests()).class_sums)
    # No stamp in the manifest: both packages restore the v0 stamp.
    ts.version = None
    tck.save_servable(ts, str(tmp_path / "bare"), 1)
    bare, _ = tck.restore_servable(tcfg, str(tmp_path / "bare"), device="cpu")
    assert bare.version == ServableVersion()
    assert jck.restore_servable(jcfg, str(tmp_path / "bare"))[0].version == JServableVersion()


def test_trainer_checkpoints_cross_both_ways(tmp_path, models):
    jm, jcfg, tm, tcfg = models
    jck.save_pytree(jm, str(tmp_path / "j"), 4, extra={"pipeline": {"epoch": 4}})
    got, step, extra = tck.restore_pytree(
        CoTMModel(ta_state=torch.zeros_like(tm.ta_state), weights=torch.zeros_like(tm.weights)),
        str(tmp_path / "j"))
    assert step == 4 and extra == {"pipeline": {"epoch": 4}}
    ta, w = model_to_arrays(got)
    np.testing.assert_array_equal(ta, np.asarray(jm.ta_state))
    np.testing.assert_array_equal(w, np.asarray(jm.weights))
    tck.save_pytree(tm, str(tmp_path / "t"), 6)
    assert sorted(os.listdir(tmp_path / "t" / "step_00000006")) == sorted(
        os.listdir(tmp_path / "j" / "step_00000004"))
    back, _, _ = jck.restore_pytree(jm, str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back.ta_state), ta)
    # Nested trees: dict keys sorted, list indices, dataclass fields.
    tree = {"b": [torch.arange(3), np.ones((2, 2), np.float32)], "a": tm,
            "h": torch.ones(4, dtype=torch.float16)}
    tck.save_pytree(tree, str(tmp_path / "n"), 1)
    names = json.loads((tmp_path / "n" / "step_00000001" / "manifest.json").read_text())
    assert list(names["leaves"]) == ["a/.ta_state", "a/.weights", "b/0", "b/1", "h"]
    out, _, _ = tck.restore_pytree(tree, str(tmp_path / "n"))
    assert torch.equal(out["b"][0], tree["b"][0]) and out["h"].dtype == torch.float16
    assert torch.equal(out["a"].weights, tm.weights)


def test_checkpointer_async_keep_and_latest(tmp_path, models):
    _, _, tm, _ = models
    ck = tck.Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(tm, step, extra={"s": step})
    ck.wait()
    os.makedirs(tmp_path / "step_backup")               # junk is skipped
    assert tck.latest_step(str(tmp_path)) == 3 == jck.latest_step(str(tmp_path))
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_0")) == [
        "step_00000002", "step_00000003"]
    got, step, extra = ck.restore(tm, device="cpu")
    assert step == 3 and extra == {"s": 3} and torch.equal(got.ta_state, tm.ta_state)
    assert tck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tck.restore_pytree(tm, str(tmp_path / "empty_dir_missing"))
    with pytest.raises(KeyError, match="missing leaf"):
        tck.restore_pytree({"x": tm.ta_state}, str(tmp_path))


@pytest.mark.parametrize("loader", ["restore_servable", "unpack_model",
                                    "DoubleBufferedLoader"])
def test_loaders_without_cuda_raise(tmp_path, models, monkeypatch, loader):
    """No device given and no CUDA: a loader refuses instead of quietly
    placing the model or the batches on the CPU."""
    _, _, tm, tcfg = models
    tck.save_servable(freeze(tm, tcfg), str(tmp_path), 1)
    blob = tio.pack_model(tm, tcfg)
    load = {
        "restore_servable": lambda **kw: tck.restore_servable(tcfg, str(tmp_path), **kw),
        "unpack_model": lambda **kw: tio.unpack_model(blob, tcfg, **kw),
        "DoubleBufferedLoader": lambda **kw: DoubleBufferedLoader(iter(()), **kw),
    }[loader]
    load(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load()


# bfloat16 leaves: the uint16 payload under "dtype": "bfloat16", both ways.

def _bf16_tree():
    """The smallest failing input (a 3-element bf16 leaf) and a wider one
    with every class of value bfloat16 has, beside an fp32 leaf."""
    bits = np.array([0x0000, 0x8000, 0x3F80, 0xBF80, 0x7F80, 0xFF80, 0x0001, 0x7F7F,
                     0x4049, 0x3DCC], dtype=np.uint16)             # +-0, +-1, +-inf, ...
    wide = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16).reshape(2, 5)
    return {"w": torch.ones(3, dtype=torch.bfloat16), "wide": wide,
            "f": torch.arange(4, dtype=torch.float32)}


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    t = np.asarray(t)
    return t.view(np.int16) if t.dtype.name == "bfloat16" else t


def test_bf16_tree_written_by_the_port_restores_in_both(tmp_path):
    tree = _bf16_tree()
    tck.save_pytree(tree, str(tmp_path), 1)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["w"]["dtype"] == "bfloat16" and leaves["f"]["dtype"] == "float32"
    template = {k: torch.zeros_like(v) for k, v in tree.items()}
    got, step, _ = tck.restore_pytree(template, str(tmp_path))
    assert step == 1
    jtemplate = {"w": jax.numpy.zeros(3, jax.numpy.bfloat16),
                 "wide": jax.numpy.zeros((2, 5), jax.numpy.bfloat16),
                 "f": jax.numpy.zeros(4, jax.numpy.float32)}
    jgot, _, _ = jck.restore_pytree(jtemplate, str(tmp_path))
    for k, v in tree.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
        assert jgot[k].dtype == jtemplate[k].dtype
        np.testing.assert_array_equal(_bits(jgot[k]), _bits(v), err_msg=k)


def test_bf16_tree_written_by_the_reference_restores_in_the_port(tmp_path):
    tree = _bf16_tree()
    jtree = {k: jax.numpy.asarray(v.float().numpy(), jax.numpy.bfloat16
                                  if v.dtype == torch.bfloat16 else jax.numpy.float32)
             for k, v in tree.items()}
    jck.save_pytree(jtree, str(tmp_path), 2)
    got, step, _ = tck.restore_pytree({k: torch.zeros_like(v) for k, v in tree.items()},
                                      str(tmp_path))
    assert step == 2
    for k, v in tree.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(_bits(got[k]), _bits(jtree[k]), err_msg=k)
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    # An async save of the same tree by the port writes the same payloads.
    ck = tck.Checkpointer(str(tmp_path / "port"))
    ck.save(got, 3)
    ck.wait()
    again, _, _ = ck.restore({k: torch.zeros_like(v) for k, v in tree.items()})
    for k, v in tree.items():
        np.testing.assert_array_equal(_bits(again[k]), _bits(v), err_msg=k)
