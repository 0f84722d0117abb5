"""device_idle.decode: the share of danube-decode's traced window (one
``generate`` call) in which no operation ran on the card (kernels,
copies, memsets; overlaps merged), in percent. The same reading as
``device_idle``, under a name of its own because it moves
``tokens_per_s``."""

from harness.readers import device_idle_pct


def read(rec):
    return device_idle_pct(rec)
