"""device_idle: the share of the traced window in which no operation ran
on the card (kernels, copies, memsets; overlaps merged), in percent."""

from harness.readers import device_idle_pct


def read(rec):
    return device_idle_pct(rec)
