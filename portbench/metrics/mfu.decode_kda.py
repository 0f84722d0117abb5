"""mfu.decode_kda: the active model FLOPs of every decode step of the
window's calls (counted in the model's own form: 2 per matrix parameter a
token passes outside the experts, 2 per parameter of the held experts it
reaches on average, 8 a KDA state element and layer, latent attention
over the positions it holds; ``harness.kimi_linear_yardstick``) over the
window's seconds times the card's dense bf16 rate, in percent: the whole
hybrid decode step's share of the card's peak."""

from harness.kimi_linear_yardstick import call_flops
from harness.lm_yardstick import bf16_flops_per_s


def read(rec):
    steps, shape = rec.facts.get("steps_in_window"), rec.facts.get("call_shape")
    if not steps or shape is None or rec.card is None or "linear_attn_config" not in rec.cfg:
        return None
    b, p, g = shape
    flops = steps // (p + g) * call_flops(rec.cfg, b, p + g)
    return 100.0 * flops / (rec.window_s * bf16_flops_per_s(rec.card))
