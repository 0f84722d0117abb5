"""Port vs reference: the dry-run and the rest of the LM roofline.

``launch.dryrun.lower_cell`` runs all 68 (arch x shape x mesh) cells on
the CPU, with the reference's keys; each cell's per-device argument
bytes equal the sum, over the reference's own abstract arguments laid
out by its own shardings on a ``jax.sharding.AbstractMesh`` of the same
shape, of ``prod(shard_shape) * itemsize``.  The HLO text parsers and
``roofline_terms`` (under the reference's TPU constants) give the
reference's numbers on its HLO strings, and ``collective_bytes_estimate``
gives the reference's floats, key for key, for every arch, shape and
profile on 16 x 16 chips, one and two pods, with each option set.
"""

import math

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import TrainConfig as JTrainConfig
from repro.launch import specs as JS
from repro.models.base import pspec_tree as j_pspec_tree
from repro.roofline import analysis as janalysis
from repro.roofline.flops import collective_bytes_estimate as j_collective
from repro.sharding import partition as jpart
from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline.flops import collective_bytes_estimate
from repro_torch.sharding import partition as tpart
from test_roofline import SAMPLE_HLO

ARCH_NAMES = sorted(J_ARCHS)

#: The keys of the reference's cell record (``repro/launch/dryrun.py``).
CELL_KEYS = {"arch", "shape", "mesh", "chips", "kind", "compile_s", "params", "active_params",
             "tokens_per_step", "model_flops_total", "model_flops_per_chip",
             "useful_flops_ratio", "memory", "roofline"}
MEMORY_KEYS = {"bytes_per_device", "argument_bytes", "output_bytes", "peak_bytes"}
TERM_KEYS = {"compute_s", "memory_s", "collective_s", "flops_per_chip", "bytes_per_chip",
             "wire_bytes_per_chip", "collectives", "chips", "dominant", "bound_step_s",
             "roofline_fraction"}

TWO_COMPUTATIONS = """
HloModule two
%body.3 (p: f32[8,128]) -> f32[8,128] {
  %x = f32[8,128]{1,0} parameter(0)
  %ar.1 = f32[8,128]{1,0} all-reduce(%x), to_apply=%add
  %ag.1 = f32[16,128]{1,0} all-gather(%ar.1), dimensions={0}
  %ags = (f32[8,128], f32[16,128]) all-gather-start(%x), dimensions={0}
  %agd = f32[16,128]{1,0} all-gather-done(%ags)
}
ENTRY %main.9 (a: f32[8,128]) -> f32[8,128] {
  %a = f32[8,128]{1,0} parameter(0)
  %rs = f32[4,128]{1,0} reduce-scatter(%a), dimensions={0}
  %a2a = f32[8,128]{1,0} all-to-all(%a), dimensions={0}
  ROOT %ar.2 = f32[8,128]{1,0} all-reduce(%a), to_apply=%add
}
"""


@pytest.fixture(autouse=True)
def restore_profiles():
    """``lower_cell`` sets the profile, as the reference's does."""
    try:
        yield
    finally:
        jpart.set_profile("tp")
        tpart.set_profile("tp")


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hlo", [SAMPLE_HLO, TWO_COMPUTATIONS, ""], ids=["sample", "two", "empty"])
def test_hlo_parsers_equal_reference(hlo):
    assert tanalysis.parse_collective_bytes(hlo) == janalysis.parse_collective_bytes(hlo)
    assert (tanalysis.collective_counts_by_computation(hlo)
            == janalysis.collective_counts_by_computation(hlo))
    for key in ("pred[3]", "bf16[2,3] f32[4]", "(s8[7], u64[1,2])", "token[]", "f32[]"):
        assert tanalysis._shape_bytes(key) == janalysis._shape_bytes(key)


def test_collective_counts_split_by_computation():
    got = tanalysis.collective_counts_by_computation(TWO_COMPUTATIONS)
    assert got == {"body.3": {"all-reduce": 1, "all-gather": 2},
                   "main.9": {"reduce-scatter": 1, "all-to-all": 1, "all-reduce": 1}}


@pytest.mark.parametrize("cost", [{"flops": 197e12 * 0.5, "bytes accessed": 819e9 * 0.1},
                                  {"flops": 1e9, "bytes accessed": 819e9},
                                  {"flops": 0.0, "bytes accessed": 0.0}, {}])
@pytest.mark.parametrize("hlo", [SAMPLE_HLO, TWO_COMPUTATIONS])
def test_roofline_terms_under_the_tpu_constants_equal_reference(cost, hlo):
    assert tanalysis.TPU_V5E == janalysis.HW
    want = janalysis.roofline_terms(cost, hlo, chips=256)
    assert tanalysis.roofline_terms(cost, hlo, chips=256, hw=tanalysis.TPU_V5E) == want


def test_roofline_terms_default_to_the_h100_and_take_analytic_collectives():
    assert tanalysis.H100 == {"peak_flops": 132 * 4096 * 1980e6, "hbm_bw": 3.35e12,
                              "ici_bw": 450e9}
    cost = {"flops": tanalysis.H100["peak_flops"] * 0.25, "bytes accessed": 3.35e12 * 0.5}
    terms = tanalysis.roofline_terms(cost, chips=4, collectives={
        "fsdp": {"wire_bytes": 450e9}, "tp": {"wire_bytes": 0.0}})
    assert terms["compute_s"] == pytest.approx(0.25)
    assert terms["memory_s"] == pytest.approx(0.5)
    assert terms["collective_s"] == pytest.approx(1.0)
    assert terms["dominant"] == "collective" and set(terms) == TERM_KEYS


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_collective_bytes_estimate_equals_reference(arch):
    cfg, jcfg = get_config(arch), J_ARCHS[arch]
    options = [{}, {"parallel_block": True}, {"gather_hoisted": True}, {"pod_int8": True}]
    for shape_name in SHAPES:
        for profile in ("tp", "dp", "serve_tp"):
            for pods in (1, 2):
                for k in (1, 4):
                    for opt in options:
                        kw = dict(dp=16, tp=16, pods=pods, microbatches=k, profile=profile,
                                  **opt)
                        got = collective_bytes_estimate(cfg, SHAPES[shape_name], **kw)
                        want = j_collective(jcfg, J_SHAPES[shape_name], **kw)
                        assert got == want, (shape_name, kw)


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------

def _ref_named(tree_specs, mesh):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree_specs,
                        is_leaf=lambda x: hasattr(x, "index"))


def _ref_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shards)
    return sum(math.prod(sh.shard_shape(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x, sh in zip(leaves, shards))


def _ref_argument_bytes(arch, shape_name, multi_pod, profile, k) -> int:
    """The reference's per-device argument bytes of a cell, from its own
    abstract arguments and shardings on an AbstractMesh."""
    jpart.set_profile(profile)
    cfg, shape = J_ARCHS[arch], J_SHAPES[shape_name]
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))
    if shape.kind == "train":
        tcfg = JTrainConfig(microbatches=k)
        assert JS.microbatches_for(cfg, shape, mesh) == k
        return (_ref_bytes(JS.abstract_train_state(cfg, tcfg), JS.state_shardings(cfg, tcfg, mesh))
                + _ref_bytes(JS.batch_specs(cfg, shape), JS.batch_shardings(cfg, shape, mesh)))
    p_sh = _ref_named(j_pspec_tree(JS.model_decls(cfg), mesh), mesh)
    params = _ref_bytes(JS.abstract_model(cfg), p_sh)
    if shape.kind == "prefill":
        return params + _ref_bytes(JS.batch_specs(cfg, shape), JS.batch_shardings(cfg, shape, mesh))
    toks = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
    t_sh = jpart.sharding_for(toks.shape, ("batch", None), mesh)
    return (params + _ref_bytes(toks, t_sh) + 4
            + _ref_bytes(JS.cache_specs(cfg, shape), JS.cache_shardings(cfg, shape, mesh)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_cell_runs_with_the_references_keys_and_argument_bytes(arch):
    cfg = get_config(arch)
    for shape_name in applicable_shapes(cfg):
        for multi_pod in (False, True):
            res = dryrun.lower_cell(arch, shape_name, multi_pod)
            train = SHAPES[shape_name].kind == "train"
            assert set(res) == CELL_KEYS | ({"microbatches"} if train else set())
            assert set(res["memory"]) == MEMORY_KEYS and set(res["roofline"]) == TERM_KEYS
            assert res["compile_s"] is None
            assert res["memory"]["bytes_per_device"] is None
            assert res["memory"]["peak_bytes"] is None
            assert res["chips"] == (512 if multi_pod else 256)
            assert res["mesh"] == ("2x16x16" if multi_pod else "16x16")
            assert set(res["roofline"]["collectives"]) == {"fsdp", "tp", "pod", "ep"}
            assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
            profile = tpart.get_profile()
            want = _ref_argument_bytes(arch, shape_name, multi_pod, profile,
                                       res.get("microbatches", 1))
            assert res["memory"]["argument_bytes"] == want, (shape_name, multi_pod)
            assert res["memory"]["output_bytes"] > 0


def test_h2o_danube_train_state_is_a_tenth_of_a_gigabyte_per_device():
    """25.64 GB of train state over 256 devices: 0.102 GB each; the two-pod
    mesh holds the same, since "pod" carries only the batch."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_production_mesh

    cfg, shape = get_config("h2o-danube-1.8b"), SHAPES["train_4k"]
    state = S.abstract_train_state(cfg, TrainConfig())
    tensors = [state["opt"]["step"], *state["params"].values(),
               *(t for part in ("m", "v", "master") for t in state["opt"][part].values())]
    assert round(sum(t.numel() * t.element_size() for t in tensors) / 1e9, 2) == 25.64
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        per = dryrun.shard_bytes(state, S.state_shardings(cfg, TrainConfig(), mesh))
        assert round(per / 1e9, 3) == 0.102
        res = dryrun.lower_cell("h2o-danube-1.8b", "train_4k", multi_pod)
        assert 0 < res["memory"]["argument_bytes"] - per <= 256 * 4096 * 4 // 16
    assert S.microbatches_for(cfg, shape, make_production_mesh()) == 8


def test_main_writes_one_json_per_cell_and_skips_what_exists(tmp_path, monkeypatch, capsys):
    import json

    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path))
    dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--both"])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["xlstm-350m__decode_32k__16x16.json", "xlstm-350m__decode_32k__2x16x16.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["compile_s"] is None and rec["kind"] == "decode"
    dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k"])
    assert "skip" in capsys.readouterr().out
    assert dryrun.cell_path("a", "b", True) == str(tmp_path / "a__b__2x16x16.json")
