"""mfu.decode: the model FLOPs of every decode step of the window's calls
(2 per matrix parameter a token passes, plus attention over the
positions it holds; ``harness.lm_yardstick``) over the window's seconds
times the card's dense bf16 rate, in percent: the whole decode step's
share of the card's peak."""

from harness.lm_yardstick import bf16_flops_per_s, call_flops


def read(rec):
    steps, shape = rec.facts.get("steps_in_window"), rec.facts.get("call_shape")
    if not steps or shape is None or rec.card is None:
        return None
    b, p, g = shape
    calls = steps // (p + g)
    flops = calls * call_flops(rec.cfg, b, p + g)
    return 100.0 * flops / (rec.window_s * bf16_flops_per_s(rec.card))
