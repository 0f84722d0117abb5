"""Port vs reference: the ConvCoTM roofline model.

``tm_serve_costs`` is the same op and byte model in both packages, so
every path gives the reference's numbers, at the paper's geometry and the
autotuner's tiny one, at batches 1 and 256, for the full pool, an active
pool of 88 and an empty one.  ``tm_path_roofline`` charges them at the
H100's ceilings, where the reference charges its TPU constants.
"""

import pytest

from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.patches import PatchSpec as JPatchSpec
from repro.roofline import analysis as janalysis
from repro.roofline.flops import TM_FUSED_PATHS as J_FUSED
from repro.roofline.flops import TM_SPARSE_PATHS as J_SPARSE
from repro.roofline.flops import tm_serve_costs as j_costs
from repro_torch import tm_path_roofline, tm_serve_costs
from repro_torch.configs.convcotm import COTM_CONFIGS
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.patches import PatchSpec
from repro_torch.roofline import TM_FUSED_PATHS, TM_SPARSE_PATHS
from repro_torch.roofline.analysis import H100_BYTES_PER_S, H100_INT_OPS_PER_S

PATHS = ("dense", "matmul", "bitpacked", "kernel", "fused", "sparse", "fused_sparse",
         "matmul_sparse")
TINY = dict(image_x=8, image_y=8, window_x=4, window_y=4)
CONFIGS = {
    "convcotm-mnist": (JCoTMConfig(), COTM_CONFIGS["convcotm-mnist"]),
    "tiny": (JCoTMConfig(n_clauses=16, n_classes=4, patch=JPatchSpec(**TINY)),
             CoTMConfig(n_clauses=16, n_classes=4, patch=PatchSpec(**TINY))),
}


def test_path_sets_match_reference():
    assert TM_SPARSE_PATHS == J_SPARSE and TM_FUSED_PATHS == J_FUSED


@pytest.mark.parametrize("n_active", [None, 88, 0], ids=["full", "active88", "empty"])
@pytest.mark.parametrize("batch", [1, 256])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("path", PATHS)
def test_costs_equal_the_references(path, config, batch, n_active):
    jcfg, tcfg = CONFIGS[config]
    assert tm_serve_costs(tcfg, path, batch, n_active=n_active) == j_costs(
        jcfg, path, batch, n_active=n_active)


@pytest.mark.parametrize("batch", [1, 256])
@pytest.mark.parametrize("path", PATHS)
def test_roofline_charges_the_h100_ceilings(path, batch):
    jcfg, tcfg = CONFIGS["convcotm-mnist"]
    got = tm_path_roofline(tcfg, path, batch, n_active=88, measured_cls_per_s=1e5)
    want = janalysis.tm_path_roofline(jcfg, path, batch, n_active=88)
    assert (got["ops"], got["bytes"], got["clauses_evaluated"]) == (
        want["ops"], want["bytes"], want["clauses_evaluated"])
    compute_s, memory_s = got["ops"] / H100_INT_OPS_PER_S, got["bytes"] / H100_BYTES_PER_S
    assert (got["compute_s"], got["memory_s"]) == (compute_s, memory_s)
    assert got["ceiling_cls_per_s"] == batch / max(compute_s, memory_s)
    assert got["bound"] == ("compute" if compute_s >= memory_s else "memory")
    assert got["achieved_fraction"] == 1e5 / got["ceiling_cls_per_s"]
    # The card's own ceilings, as chip_smoke.py passes them.
    mine = tm_path_roofline(tcfg, path, batch, n_active=88, ops_per_s=2.0,
                            bytes_per_s=3.0)
    assert mine["ceiling_cls_per_s"] == batch / max(got["ops"] / 2.0, got["bytes"] / 3.0)


def test_h100_constants():
    assert H100_BYTES_PER_S == 3.35e12
    assert H100_INT_OPS_PER_S == pytest.approx(1.673e13, rel=1e-3)


def test_unknown_path_raises_in_both():
    jcfg, tcfg = CONFIGS["tiny"]
    for fn, cfg in ((tm_serve_costs, tcfg), (j_costs, jcfg),
                    (tm_path_roofline, tcfg), (janalysis.tm_path_roofline, jcfg)):
        with pytest.raises(ValueError, match="no cost model"):
            fn(cfg, "nope", 1)
