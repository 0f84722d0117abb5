"""ingress_pack_roofline: the ingress kernel's bound over its device time
in the traced window, in percent.  A launch's bound is the larger of its
bytes (the booleanized images in, the packed literal words out) over the
memory rate and one operation per word written over the integer rate."""

from harness.readers import ingress_pack_roofline_pct


def read(rec):
    return ingress_pack_roofline_pct(rec)
