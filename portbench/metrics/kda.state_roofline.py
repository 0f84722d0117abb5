"""kda.state_roofline: the KDA decode kernel's bound over the device time
of its launches in the traced call, in percent.  The launches are the
device rows whose names hold ``kda_decode`` (``csrc/kda_decode.cu``, which
the trace names under a replayed CUDA graph too); the bound of each is
the larger of its bytes (each state read and written once, ``q, k, v, g,
beta`` in, ``o`` out, float32) over the memory rate and its FLOPs over the
float32 rate of the CUDA cores (``harness.kimi_linear_yardstick.kda_bound_s``).  A program
without such rows gives no reading."""

from harness.kimi_linear_yardstick import kda_bound_s

KERNEL = "kda_decode"


def read(rec):
    tr, shape = rec.trace, rec.facts.get("call_shape")
    if tr is None or shape is None or rec.card is None or "linear_attn_config" not in rec.cfg:
        return None
    rows = [(s, e) for n, s, e in tr.device if KERNEL in n]
    seconds = sum(e - s for s, e in rows) * 1e-6
    if not rows or seconds <= 0:
        return None
    return 100.0 * kda_bound_s(rec.cfg, shape[0], len(rows), rec.card) / seconds
