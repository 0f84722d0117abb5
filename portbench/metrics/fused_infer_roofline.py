"""fused_infer_roofline: the fused clause kernel's bound over its device
time in the traced window, in percent.  A launch's bound is the larger of
its bytes over the memory rate and the word tests its images need over
the card's integer rate (``harness.readers``)."""

from harness.readers import fused_infer_roofline_pct


def read(rec):
    return fused_infer_roofline_pct(rec)
