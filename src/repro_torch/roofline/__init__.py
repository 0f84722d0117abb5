"""Analytic cost model of the ConvCoTM eval paths, and their roofline on an
H100 (counterpart of the ConvCoTM half of ``repro/roofline/``; the LM half
is not ported)."""

from repro_torch.roofline.analysis import tm_path_roofline
from repro_torch.roofline.flops import TM_FUSED_PATHS, TM_SPARSE_PATHS, tm_serve_costs

__all__ = ["TM_FUSED_PATHS", "TM_SPARSE_PATHS", "tm_path_roofline", "tm_serve_costs"]
