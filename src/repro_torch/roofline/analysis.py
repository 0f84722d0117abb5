"""Roofline terms of the LM substrate's cells and of the ConvCoTM eval
paths on an NVIDIA H100: the port's copy of ``repro/roofline/analysis.py``.

``roofline_terms`` gives the three terms of a per-chip program in seconds
(compute, memory, collective) and the dominant one, against the ceilings
of ``hw``: :data:`H100` by default, the reference's TPU v5e constants as
:data:`TPU_V5E`, so the reference's own numbers can be reproduced.  The
collective bytes come from HLO text (``parse_collective_bytes``, ring
factors on operand bytes) or, where there is no compiler to give HLO, from
an analytic count passed as ``collectives``
(``flops.collective_bytes_estimate``, keyed by mechanism).  The text
parsers read the HLO of any XLA module; the port itself emits none.

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

import re
from typing import Any, Dict, Optional

from repro_torch.roofline.flops import tm_serve_costs

__all__ = [
    "COLLECTIVE_OPS",
    "H100",
    "H100_BF16_FLOPS_PER_S",
    "H100_BYTES_PER_S",
    "H100_INT_OPS_PER_S",
    "H100_NVLINK_BYTES_PER_S",
    "TPU_V5E",
    "collective_counts_by_computation",
    "model_flops",
    "parse_collective_bytes",
    "roofline_terms",
    "tm_path_roofline",
]

#: HBM3 bytes per second of an H100 SXM (NVIDIA's data sheet).
H100_BYTES_PER_S = 3.35e12
#: 32-bit integer results per second of an H100 80GB HBM3: 132 SMs x 64 per
#: clock x 1,980 MHz (the highest SM clock ``nvidia-smi`` reports, 700 W).
H100_INT_OPS_PER_S = 132 * 64 * 1980e6
#: Dense bf16 tensor-core FLOP/s of the same card: 132 SMs x 4,096 FLOPs per
#: clock x 1,980 MHz, the figure ``chip_smoke.py``'s ``[roofline] lm`` line
#: derives (the data sheet gives 989 TFLOP/s at its 1,830 MHz boost clock).
H100_BF16_FLOPS_PER_S = 132 * 4096 * 1980e6
#: NVLink 4 bytes per second, one direction, of an H100 SXM: 900 GB/s in
#: both directions together (NVIDIA's H100 SXM data sheet).
H100_NVLINK_BYTES_PER_S = 450e9

#: The H100's ceilings under the reference's keys.
H100 = {"peak_flops": H100_BF16_FLOPS_PER_S, "hbm_bw": H100_BYTES_PER_S,
        "ici_bw": H100_NVLINK_BYTES_PER_S}
#: The reference's TPU v5e per-chip constants (its ``HW``): 197 TFLOP/s
#: bf16, 819 GB/s HBM, ~50 GB/s a link of the inter-chip interconnect.
TPU_V5E = {"peak_flops": 197e12, "hbm_bw": 819e9, "ici_bw": 50e9}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: Ring-algorithm wire factors on operand bytes (asymptotic in N, an upper
#: bound within (N-1)/N of exact).
_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_text: str) -> int:
    """Sum bytes over every 'dtype[dims]' occurrence in a type string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def parse_collective_bytes(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per collective opcode: {count, operand_bytes, wire_bytes}.

    Two passes: a map of each definition's name to its shape's bytes, then
    for each collective instruction the sum of its operands' bytes (its
    result's when no operand is known, e.g. a constant folded inline)."""
    defs: Dict[str, int] = {}
    lines = hlo_text.splitlines()
    for ln in lines:
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s([\w\-]+)\(", ln)
        if m:
            defs[m.group(1)] = _shape_bytes(m.group(2))

    out = {op: {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0}
           for op in COLLECTIVE_OPS}
    for ln in lines:
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s([\w\-]+)\((.*)", ln)
        if not m:
            continue
        _, result_type, opcode, rest = m.groups()
        base = None
        for op in COLLECTIVE_OPS:
            if opcode == op or opcode.startswith(op + "-start"):
                base = op
                break
        if base is None:          # other fused forms, e.g. "all-gather-start"
            for op in COLLECTIVE_OPS:
                if opcode.startswith(op):
                    base = op
                    break
        if base is None or opcode.endswith("-done"):
            continue
        operand_names = re.findall(r"%?([\w.\-]+)", rest.split(")")[0])
        ob = sum(defs.get(n, 0) for n in operand_names if n in defs)
        if ob == 0:
            ob = _shape_bytes(result_type)
        out[base]["count"] += 1
        out[base]["operand_bytes"] += float(ob)
        out[base]["wire_bytes"] += float(ob) * _WIRE_FACTOR[base]
    return out


def collective_counts_by_computation(hlo_text: str) -> Dict[str, Dict[str, int]]:
    """Collective instruction counts per HLO computation (e.g. the body of
    a layer loop against the entry)."""
    out: Dict[str, Dict[str, int]] = {}
    current = "<entry>"
    for ln in hlo_text.splitlines():
        m = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\([^)]*\)\s*->", ln)
        if m and "=" not in ln.split("->")[0]:
            current = m.group(1)
            continue
        m2 = re.match(r"\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*.+?\s([\w\-]+)\(", ln)
        if not m2:
            continue
        opcode = m2.group(1)
        for op in COLLECTIVE_OPS:
            if opcode == op or (opcode.startswith(op) and not opcode.endswith("-done")):
                out.setdefault(current, {}).setdefault(op, 0)
                out[current][op] += 1
                break
    return out


def roofline_terms(
    cost: Dict[str, float],
    hlo_text: str = "",
    *,
    chips: int,
    hw: Dict[str, float] = H100,
    collectives: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Any]:
    """Three roofline terms in seconds of a per-chip program: ``flops`` over
    ``hw["peak_flops"]``, ``bytes accessed`` over ``hw["hbm_bw"]``, and the
    collectives' wire bytes over ``hw["ici_bw"]``.  The collectives are
    parsed from ``hlo_text``, or taken as given in ``collectives`` (each
    entry with its ``wire_bytes``)."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    coll = parse_collective_bytes(hlo_text) if collectives is None else collectives
    wire = sum(v["wire_bytes"] for v in coll.values())
    terms = {
        "compute_s": flops / hw["peak_flops"],
        "memory_s": bytes_acc / hw["hbm_bw"],
        "collective_s": wire / hw["ici_bw"],
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_acc,
        "wire_bytes_per_chip": wire,
        "collectives": coll,
        "chips": chips,
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["dominant"] = dom.replace("_s", "")
    step = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["bound_step_s"] = step
    terms["roofline_fraction"] = terms["compute_s"] / step if step > 0 else 0.0
    return terms


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
