"""Roofline ceilings of the ConvCoTM eval paths on an NVIDIA H100, and the
LM substrate's ideal model FLOPs (``model_flops``, the reference's
``6·N·D`` / ``2·N·D``).  ``roofline_terms`` and the HLO parsers of the
reference's ``analysis.py`` wait for the sharding half of the LM substrate.

``tm_path_roofline`` is the port's copy of the reference's
(``repro/roofline/analysis.py``) with the H100's ceilings in place of the
reference's TPU constants:

  * ``bytes_per_s``: 3.35e12 B/s, the H100 SXM's HBM3 rate (NVIDIA's data
    sheet);
  * ``ops_per_s``: 1.673e13 results/s, the integer ceiling that
    ``chip_smoke.py:ceilings()`` derives for an H100 80GB HBM3 at a 700 W
    power limit: 132 SMs x 64 32-bit integer results per clock x its
    highest SM clock, 1,980 MHz.

A stated divergence from the reference: word and bit operations are
charged at that integer ceiling, where the reference charges them at its
floating-point peak.  The packed paths' word tests have no tensor-core or
floating-point form on this card, so the integer rate is their ceiling.
``chip_smoke.py`` passes the ceilings it reads from the card it runs on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.roofline.flops import tm_serve_costs

__all__ = ["H100_BYTES_PER_S", "H100_INT_OPS_PER_S", "model_flops", "tm_path_roofline"]

#: HBM3 bytes per second of an H100 SXM (NVIDIA's data sheet).
H100_BYTES_PER_S = 3.35e12
#: 32-bit integer results per second of an H100 80GB HBM3: 132 SMs x 64 per
#: clock x 1,980 MHz (the highest SM clock ``nvidia-smi`` reports, 700 W).
H100_INT_OPS_PER_S = 132 * 64 * 1980e6


def model_flops(n_params: int, n_active_params: int, tokens: int, kind: str) -> float:
    """Ideal model FLOPs: 6·N·D train, 2·N·D forward-only (per step), N the
    active parameters."""
    n = n_active_params
    return (6.0 if kind == "train" else 2.0) * n * tokens


def tm_path_roofline(
    config,
    path_name: str,
    batch: int = 1,
    *,
    n_active: Optional[int] = None,
    measured_cls_per_s: Optional[float] = None,
    ops_per_s: float = H100_INT_OPS_PER_S,
    bytes_per_s: float = H100_BYTES_PER_S,
) -> Dict[str, Any]:
    """Roofline ceiling of one ConvCoTM eval-path batch:

      ``ceiling_cls_per_s = batch / max(ops / ops_per_s, bytes / bytes_per_s)``

    from :func:`~repro_torch.roofline.flops.tm_serve_costs`.  With
    ``measured_cls_per_s`` the result also carries ``achieved_fraction``
    (measured over ceiling); a fraction above 1 means the cost model or
    the timer is wrong.
    """
    costs = tm_serve_costs(config, path_name, batch, n_active=n_active)
    compute_s = costs["ops"] / ops_per_s
    memory_s = costs["bytes"] / bytes_per_s
    bound_s = max(compute_s, memory_s)
    out: Dict[str, Any] = {
        "path": path_name,
        "batch": batch,
        "ops": costs["ops"],
        "bytes": costs["bytes"],
        "clauses_evaluated": costs["clauses_evaluated"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "ceiling_cls_per_s": batch / bound_s if bound_s > 0 else float("inf"),
    }
    if measured_cls_per_s is not None:
        out["measured_cls_per_s"] = measured_cls_per_s
        out["achieved_fraction"] = (
            measured_cls_per_s / out["ceiling_cls_per_s"]
            if out["ceiling_cls_per_s"] > 0 else 0.0
        )
    return out
