"""Operations and device-memory bytes of one ConvCoTM eval-path batch.

The port's copy of ``tm_serve_costs`` and its path sets from the
reference's ``roofline/flops.py``: the same op and byte model, so the same
numbers for the same geometry.  Only the ConvCoTM half is ported.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["TM_FUSED_PATHS", "TM_SPARSE_PATHS", "tm_serve_costs"]

#: Paths whose clause axis is the active pool (empty clauses pruned by
#: ``serve.servable.analyze_sparsity``) rather than the full pool.
TM_SPARSE_PATHS = ("sparse", "fused_sparse", "matmul_sparse")

#: Paths whose clause outputs never round-trip through device memory
#: (class sums taken inside the kernel).
TM_FUSED_PATHS = ("fused", "fused_sparse")


def tm_serve_costs(
    config, path_name: str, batch: int = 1, *, n_active: Optional[int] = None
) -> Dict[str, float]:
    """Analytic op and byte costs of one ConvCoTM eval-path batch.

    ``config`` is a :class:`~repro_torch.core.cotm.CoTMConfig` (geometry
    fields only); ``n_active`` is the active-clause count of the sparse
    paths (default: the full pool).  Returns:

      * ``ops``: elementary operations, one per lane-element operation:
        multiply-adds counted twice for the matmul paths, word operations
        (not, and, compare) for the packed paths, byte ANDs and compares
        for ``dense``;
      * ``bytes``: the device-memory floor: the literal stream in, the
        model image read once per batch, the clause outputs' round trip
        for the unfused paths, the class sums out;
      * ``lit_bytes``, ``model_bytes`` and ``clauses_evaluated``.
    """
    spec = config.patch
    b = float(batch)
    p = float(spec.n_patches)        # patches per image
    lit = float(spec.n_literals)     # 2o dense literal bits
    w = float(spec.n_words)          # packed 32-bit words per patch
    c = float(config.n_clauses)
    m = float(config.n_classes)
    c_a = c if n_active is None else float(n_active)
    c_eval = c_a if path_name in TM_SPARSE_PATHS else c

    sums_ops = 2.0 * b * c_eval * m          # Eq. (3) int8 dot
    or_ops = b * c_eval * p                  # sequential OR (Eq. 6)

    if path_name == "dense":
        ops = 2.0 * b * p * c * lit + or_ops + sums_ops     # AND + reduce
        lit_bytes = b * p * lit                              # uint8 stream
        model_bytes = c * lit + c + m * c
    elif path_name in ("matmul", "matmul_sparse"):
        # Violation-count matmul: 2*B*P*C*2o + the zero compare.
        ops = 2.0 * b * p * c_eval * lit + b * p * c_eval + or_ops + sums_ops
        lit_bytes = b * p * lit
        model_bytes = c_eval * lit + m * c_eval
    elif path_name in ("bitpacked", "kernel", "fused", "sparse", "fused_sparse"):
        # Word operations per (patch, clause, word): not, and, compare.
        ops = 3.0 * b * p * c_eval * w + or_ops + sums_ops
        lit_bytes = b * p * w * 4.0                          # 32-bit word stream
        model_bytes = c_eval * w * 4.0 + m * c_eval
        if path_name in ("bitpacked", "kernel"):
            model_bytes += c                                 # nonempty mask
    else:
        raise ValueError(f"no cost model for eval path {path_name!r}")

    out_bytes = b * m * 4.0                                  # int32 class sums
    fired_bytes = 0.0 if path_name in TM_FUSED_PATHS else 2.0 * b * c_eval
    return {
        "ops": ops,
        "bytes": lit_bytes + model_bytes + fired_bytes + out_bytes,
        "lit_bytes": lit_bytes,
        "model_bytes": model_bytes,
        "clauses_evaluated": c_eval,
    }
