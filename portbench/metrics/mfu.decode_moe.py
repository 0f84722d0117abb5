"""mfu.decode_moe: the active model FLOPs of every decode step of the
window's calls (counted in the model's own form: 2 per active matrix
parameter a token passes, its 6 chosen experts among them, plus attention
over the positions it holds; ``harness.mla_moe_yardstick``) over the
window's seconds times the card's dense bf16 rate, in percent: the whole
MoE decode step's share of the card's peak."""

from harness.lm_yardstick import bf16_flops_per_s
from harness.mla_moe_yardstick import call_flops


def read(rec):
    steps, shape = rec.facts.get("steps_in_window"), rec.facts.get("call_shape")
    if not steps or shape is None or rec.card is None or "n_routed_experts" not in rec.cfg:
        return None
    b, p, g = shape
    flops = steps // (p + g) * call_flops(rec.cfg, b, p + g)
    return 100.0 * flops / (rec.window_s * bf16_flops_per_s(rec.card))
