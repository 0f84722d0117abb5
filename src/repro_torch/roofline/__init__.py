"""Analytic cost models and rooflines (the port of ``repro/roofline/``).

The ConvCoTM half (``tm_serve_costs``, ``tm_path_roofline`` at the H100's
ceilings) and the LM substrate's (``flops_estimate``,
``hbm_bytes_estimate``, ``collective_bytes_estimate``, ``model_flops``,
``roofline_terms`` and the HLO text parsers).
"""

from repro_torch.roofline.analysis import (
    H100,
    TPU_V5E,
    collective_counts_by_computation,
    model_flops,
    parse_collective_bytes,
    roofline_terms,
    tm_path_roofline,
)
from repro_torch.roofline.flops import (
    TM_FUSED_PATHS,
    TM_SPARSE_PATHS,
    collective_bytes_estimate,
    flops_estimate,
    hbm_bytes_estimate,
    tm_serve_costs,
)

__all__ = [
    "H100",
    "TM_FUSED_PATHS",
    "TM_SPARSE_PATHS",
    "TPU_V5E",
    "collective_bytes_estimate",
    "collective_counts_by_computation",
    "flops_estimate",
    "hbm_bytes_estimate",
    "model_flops",
    "parse_collective_bytes",
    "roofline_terms",
    "tm_path_roofline",
    "tm_serve_costs",
]
