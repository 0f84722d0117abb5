"""moe.experts_roofline: the routed experts' bound over the device time of
their grouped products in the traced call, in percent.  The products are
the device rows of ``torch._grouped_mm`` (CUTLASS's grouped GEMM, named by
its ``GroupProblemShape``, and the kernel that prepares its problem
sizes); the bound adds, for every routed layer's call, the larger of the
bytes of the experts the program's routing counts saw hit plus the pairs'
rows in and out over the memory rate, and its FLOPs over the bf16 rate
(``harness.mla_moe_yardstick.experts_bound_s``).  A program that records
no counts, or runs no grouped product, gives no reading."""

from harness.mla_moe_yardstick import experts_bound_s

#: Parts of the device rows' names that are the grouped products' work.
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(rec):
    ends, tr = rec.facts.get("expert_counts"), rec.trace
    if not ends or tr is None or rec.card is None:
        return None
    seconds = sum(e - s for n, s, e in tr.device if any(k in n for k in KERNELS)) * 1e-6
    if seconds <= 0:
        return None
    return 100.0 * experts_bound_s(rec.cfg, ends, rec.card) / seconds
