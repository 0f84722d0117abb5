"""Analytic cost models and rooflines (the port of ``repro/roofline/``).

Ported: the ConvCoTM half (``tm_serve_costs``, ``tm_path_roofline`` at the
H100's ceilings) and the LM substrate's forward half (``flops_estimate``,
``hbm_bytes_estimate``, ``model_flops``).  ``collective_bytes_estimate``,
``roofline_terms`` and the HLO parsers wait for the sharding half of the
LM substrate.
"""

from repro_torch.roofline.analysis import model_flops, tm_path_roofline
from repro_torch.roofline.flops import (
    TM_FUSED_PATHS,
    TM_SPARSE_PATHS,
    flops_estimate,
    hbm_bytes_estimate,
    tm_serve_costs,
)

__all__ = [
    "TM_FUSED_PATHS",
    "TM_SPARSE_PATHS",
    "flops_estimate",
    "hbm_bytes_estimate",
    "model_flops",
    "tm_path_roofline",
    "tm_serve_costs",
]
