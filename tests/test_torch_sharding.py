"""Port vs reference: the LM substrate's sharding rules, specs and meshes,
held entry for entry.

The reference's ``spec``, ``sharding_for``, ``pspec_tree``,
``state_shardings``, ``batch_shardings``, ``cache_shardings`` and
``microbatches_for`` run on ``jax.sharding.AbstractMesh`` (no devices);
the port's run on :class:`DeviceMesh`es of the ``meta`` device of the same
shapes: (16, 16) and (2, 16, 16), the production meshes, and (2, 4) and
(1, 1), for every arch, shape and profile.  Where the reference stacks a
group of layers along a leading axis, the port's per-layer spec equals the
reference's without its leading ``None`` and holds the same shard of
every other dim.  Then the reference's own spec tests (``tests/test_specs.py``)
mirrored on the port: the 40 assigned cells, cache layouts, train-state
coverage, the microbatch heuristic.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import TrainConfig as JTrainConfig
from repro.launch import specs as JS
from repro.models.base import pspec_tree as j_pspec_tree
from repro.models.transformer import layer_split
from repro.sharding import partition as jpart
from repro_torch.configs import ARCHS, SHAPES, TrainConfig, applicable_shapes, get_config
from repro_torch.convert import _ref_index
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as S
from repro_torch.models.base import pspec_tree
from repro_torch.sharding import partition as tpart

ARCH_NAMES = sorted(J_ARCHS)
PROFILES = ("tp", "dp", "serve_tp")
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def meshes(name):
    """(reference AbstractMesh, port DeviceMesh of ``meta``) of one shape."""
    shape, axes = MESHES[name]
    grid = torch.device("meta")
    for n in reversed(shape):
        grid = (grid,) * n
    return AbstractMesh(shape, axes), tmesh.DeviceMesh(grid, axes)


@pytest.fixture
def profile():
    """Sets one sharding profile in both packages; restores "tp"."""
    def use(name):
        jpart.set_profile(name)
        tpart.set_profile(name)

    try:
        yield use
    finally:
        use("tp")


def _ref_node(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

LOGICAL = [(), (None,), ("batch", None), ("batch", None, None), ("fsdp", "tensor"),
           ("tensor", "fsdp"), ("expert", "fsdp", None), (None, "seq", None),
           (("batch", "seq"), None), ("clause",), ("replicated", "fsdp"), ("no-such", "batch")]
SHAPES_FOR = [(256, 4096), (1, 4096), (32, 7), (48, 64, 1024), (512, 3, 6)]


def test_rules_and_profiles_are_the_references():
    assert tpart.PROFILES == jpart.PROFILES
    assert tpart.get_profile() == "tp"
    assert tpart.LOGICAL_RULES == jpart.LOGICAL_RULES
    with pytest.raises(KeyError, match="unknown sharding profile"):
        tpart.set_profile("no-such")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("prof", PROFILES)
def test_spec_sharding_for_and_axis_sizes_equal_reference(mesh_name, prof, profile):
    profile(prof)
    assert tpart.get_profile() == jpart.get_profile() == prof
    jm, tm = meshes(mesh_name)
    for logical in LOGICAL:
        assert tpart.spec(logical, tm) == tuple(jpart.spec(logical, jm)), logical
        for shape in SHAPES_FOR:
            if len(shape) < len(logical):
                continue
            want = jpart.sharding_for(shape, logical, jm)
            got = tpart.sharding_for(shape, logical, tm)
            assert got.spec == tuple(want.spec), (logical, shape)
            assert got.mesh is tm
            if len(logical) == len(shape):
                assert got.shard_shape(shape) == want.shard_shape(shape), (logical, shape)
    for axis in ("batch", "fsdp", "tensor", "expert", "seq", "clause", "replicated"):
        assert tpart.mesh_axis_size(tm, axis) == jpart.mesh_axis_size(jm, axis)


def test_shard_is_a_no_op_and_shard_shape_refuses_a_dim_that_does_not_divide():
    _, tm = meshes("2x4")
    x = torch.ones(3, 5)
    assert tpart.shard(x, ("batch", None), tm) is x
    with pytest.raises(ValueError, match="does not divide"):
        tpart.NamedSharding(tm, ("data",)).shard_shape((3,))


def test_single_device_mesh_holds_one_named_device():
    m = tpart.single_device_mesh("cpu")
    assert m.axis_names == ("data",) and m.size == 1 and m.flat == (torch.device("cpu"),)


def test_production_meshes_are_the_references_grids_over_meta():
    assert tmesh.required_devices(False) == 256 and tmesh.required_devices(True) == 512
    for mp, shape, axes in ((False, (16, 16), ("data", "model")),
                            (True, (2, 16, 16), ("pod", "data", "model"))):
        m = tmesh.make_production_mesh(multi_pod=mp)
        assert m.axis_names == axes and tuple(m.shape.values()) == shape
        assert m.size == tmesh.required_devices(mp)
        assert set(m.flat) == {torch.device("meta")}
    cpu = tmesh.make_production_mesh(multi_pod=False, device="cpu")
    assert set(cpu.flat) == {torch.device("cpu")}


# ---------------------------------------------------------------------------
# Parameters and train state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pspec_tree_and_state_shardings_equal_reference(arch, prof, profile):
    """Every parameter's spec, its m/v/master/residual specs and its shard
    shape, on all four meshes; the step's spec is replicated."""
    profile(prof)
    cfg, jcfg = get_config(arch), J_ARCHS[arch]
    decls = S.model_decls(cfg)
    for mesh_name in MESHES:
        jm, tm = meshes(mesh_name)
        jtree = j_pspec_tree(JS.model_decls(jcfg), jm)
        ttree = pspec_tree(decls, tm)
        jstate = JS.state_shardings(jcfg, JTrainConfig(grad_compression=True), jm)
        tstate = S.state_shardings(cfg, TrainConfig(grad_compression=True), tm)
        jshapes = JS.abstract_model(jcfg)
        names = [n for n, _ in S.abstract_model(cfg).named_parameters()]
        assert list(tstate["params"]) == names
        for name, p in S.abstract_model(cfg).named_parameters():
            path = tuple(int(k) if k.isdigit() else k for k in name.split("."))
            keys, j = _ref_index(cfg, path)
            want = tuple(_ref_node(jtree, keys))
            got = tuple(_ref_node(ttree, path))
            assert (want if j is None else want[1:]) == got, (mesh_name, name)
            if j is not None:
                assert want[0] is None, (mesh_name, name)
            stacked = tuple(_ref_node(jshapes, keys).shape)
            for part in ("m", "v", "master"):
                assert tstate["opt"][part][name].spec == got
            assert tstate["residual"][name].spec == tstate["params"][name].spec == got
            jshard = _ref_node(jstate["params"], keys).shard_shape(stacked)
            tshard = tstate["params"][name].shard_shape(tuple(p.shape))
            assert (jshard if j is None else jshard[1:]) == tshard, (mesh_name, name)
        assert tstate["opt"]["step"].spec == tuple(jstate["opt"]["step"].spec) == ()


# ---------------------------------------------------------------------------
# Batches and caches
# ---------------------------------------------------------------------------

_J_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
             jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same_meta(t, sds):
    assert tuple(t.shape) == tuple(sds.shape) and t.device.type == "meta"
    assert _J_DTYPES[jnp.dtype(sds.dtype)] == t.dtype


@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_specs_and_shardings_equal_reference(arch, prof, profile):
    profile(prof)
    cfg, jcfg = get_config(arch), J_ARCHS[arch]
    for shape_name in SHAPES:
        jb, tb = JS.batch_specs(jcfg, J_SHAPES[shape_name]), S.batch_specs(cfg, SHAPES[shape_name])
        assert set(jb) == set(tb)
        for k in jb:
            _same_meta(tb[k], jb[k])
        assert S._frontend_split(cfg, 4096) == JS._frontend_split(jcfg, 4096)
        for mesh_name in MESHES:
            jm, tm = meshes(mesh_name)
            want = JS.batch_shardings(jcfg, J_SHAPES[shape_name], jm)
            got = S.batch_shardings(cfg, SHAPES[shape_name], tm)
            assert {k: v.spec for k, v in got.items()} == {k: tuple(v.spec)
                                                          for k, v in want.items()}


def _cache_pairs(cfg, ref, port):
    """``(reference leaf, stacked?, port leaf)`` over the reference's cache
    tree and the port's per-layer lists."""
    if cfg.is_encoder_decoder:
        for part in ("self", "cross"):
            for i, layer in enumerate(port[part]):
                for leaf, t in layer.items():
                    yield ref[part][leaf], i, t
        return
    pattern, n_full, _ = layer_split(cfg)
    lp = len(pattern)
    for i, layer in enumerate(port):
        for leaf, t in layer.items():
            if i < n_full * lp:
                yield ref["cyc"][str(i % lp)][leaf], i // lp, t
            else:
                yield ref["tail"][str(i - n_full * lp)][leaf], None, t


@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_and_shardings_equal_reference(arch, prof, profile):
    """Each layer's cache shape and spec is the reference's stacked one
    without its leading axis, on every applicable shape and mesh."""
    profile(prof)
    cfg, jcfg = get_config(arch), J_ARCHS[arch]
    for shape_name in applicable_shapes(cfg):
        jspecs = JS.cache_specs(jcfg, J_SHAPES[shape_name])
        tspecs = S.cache_specs(cfg, SHAPES[shape_name])
        covered = set()
        for ref, j, t in _cache_pairs(cfg, jspecs, tspecs):
            want = tuple(ref.shape)
            assert (want if j is None else want[1:]) == tuple(t.shape)
            assert t.device.type == "meta"
            covered.add((id(ref), j))
        tail = jspecs.get("tail", {})
        tail_ids = {id(x) for x in jax.tree.leaves(tail)}
        assert covered == {(id(x), j) for x in jax.tree.leaves(jspecs)
                           for j in ([None] if id(x) in tail_ids else range(x.shape[0]))}
        for mesh_name in MESHES:
            jm, tm = meshes(mesh_name)
            jsh = JS.cache_shardings(jcfg, J_SHAPES[shape_name], jm)
            tsh = S.cache_shardings(cfg, SHAPES[shape_name], tm)
            for (ref, j, got), (_, _, t) in zip(_cache_pairs(cfg, jsh, tsh),
                                                _cache_pairs(cfg, jspecs, tspecs)):
                want = tuple(ref.spec)
                assert (want if j is None else want[1:]) == got.spec, (shape_name, mesh_name)
                got.shard_shape(tuple(t.shape))


@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_microbatches_for_equals_reference(arch, prof, profile):
    profile(prof)
    cfg, jcfg = get_config(arch), J_ARCHS[arch]
    for shape_name in SHAPES:
        for mesh_name in MESHES:
            jm, tm = meshes(mesh_name)
            assert (S.microbatches_for(cfg, SHAPES[shape_name], tm)
                    == JS.microbatches_for(jcfg, J_SHAPES[shape_name], jm))


# ---------------------------------------------------------------------------
# The reference's own spec tests, on the port
# ---------------------------------------------------------------------------

def test_forty_assigned_cells():
    total = sum(len(applicable_shapes(c)) for c in ARCHS.values())
    assert len(ARCHS) == 10 and 10 * len(SHAPES) == 40
    assert total == 34
    skipped = {name for name, c in ARCHS.items() if "long_500k" not in applicable_shapes(c)}
    assert skipped == {
        "mistral-nemo-12b", "codeqwen1.5-7b", "qwen2-moe-a2.7b",
        "phi3.5-moe-42b-a6.6b", "seamless-m4t-large-v2", "qwen2-vl-7b",
    }


def test_encdec_encoder_gets_full_sequence():
    b = S.batch_specs(get_config("seamless-m4t-large-v2"), SHAPES["train_4k"])
    assert b["frontend_embeds"].shape == (256, 4096, 1024)
    assert b["dec_tokens"].shape == (256, 1024)


def test_cache_layouts():
    k = S.cache_specs(get_config("mistral-nemo-12b"), SHAPES["decode_32k"])[0]["k"]
    assert k.shape == (128, 8, 32768, 128)                       # B, KV, S, hd
    danube = get_config("h2o-danube-1.8b")
    assert S.cache_specs(danube, SHAPES["long_500k"])[0]["k"].shape[-2] == danube.sliding_window
    xl = S.cache_specs(get_config("xlstm-350m"), SHAPES["long_500k"])
    assert xl[0]["C"].shape == (1, 4, 512, 512)                 # no sequence dim
    rg = get_config("recurrentgemma-2b")
    hybrid = S.cache_specs(rg, SHAPES["decode_32k"])
    assert set(hybrid[0]) == {"h", "conv"} and set(hybrid[2]) == {"k", "v"}
    assert hybrid[2]["k"].shape[-2] == rg.local_window
    assert len(hybrid) == 26


def test_train_state_covers_opt_and_residual():
    st = S.abstract_train_state(get_config("h2o-danube-1.8b"), TrainConfig(grad_compression=True))
    assert set(st) == {"params", "opt", "residual"}
    assert set(st["opt"]) == {"step", "m", "v", "master"}
    assert st["opt"]["step"].dtype == torch.int32 and st["opt"]["step"].shape == ()
    for part in ("m", "v", "master"):
        assert all(t.dtype == torch.float32 for t in st["opt"][part].values())
    assert set(st["params"]) == set(st["opt"]["m"]) == set(st["residual"])
    assert all(t.device.type == "meta" for t in st["params"].values())
    opt = S.opt_state_like(st["opt"])
    assert opt.step is st["opt"]["step"] and opt.master is st["opt"]["master"]


def test_microbatch_heuristic_divides():
    mesh = tpart.single_device_mesh("cpu")
    for cfg in ARCHS.values():
        for sn in applicable_shapes(cfg):
            k = S.microbatches_for(cfg, SHAPES[sn], mesh)
            assert SHAPES[sn].global_batch % k == 0
