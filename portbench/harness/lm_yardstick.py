"""The LM decode's yardstick: the model FLOPs of a token and the card's
dense bf16 rate, worked out from the configuration and the card's facts,
never from the program.

A token at position ``p`` (0-based) costs 2 FLOPs per matrix parameter it
passes (every layer's ``Wq``, ``Wk``, ``Wv``, ``Wo``, ``Wgate``, ``Wup``,
``Wdown`` and the head; the embedding is a lookup) plus attention over
the positions it holds: ``4 * n_heads * head_dim`` per layer and
position, for ``min(p + 1, sliding_window)`` positions (q.k and the
weighted sum of v).  The bf16 rate is SMs x the highest SM clock x 4,096
dense bf16 tensor-core FLOPs per clock per SM (132 x 1.83 GHz x 4,096 =
989 TFLOP/s, the H100 SXM data sheet's dense bf16 rate).
"""

from __future__ import annotations

from typing import Dict

__all__ = ["BF16_FLOPS_PER_CLOCK_PER_SM", "bf16_flops_per_s", "call_flops",
           "matrix_params"]

BF16_FLOPS_PER_CLOCK_PER_SM = 4096


def matrix_params(cfg: Dict) -> int:
    d, h, kv, hd, ff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                        cfg["d_ff"])
    layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
    return cfg["n_layers"] * layer + d * cfg["vocab_size"]


def call_flops(cfg: Dict, batch: int, steps: int) -> float:
    """Model FLOPs of one call's ``steps`` decode steps (positions
    ``0..steps-1``) for ``batch`` sequences."""
    window = cfg.get("sliding_window") or steps
    held = sum(min(p + 1, window) for p in range(steps))
    per_pos = 4 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"]
    return float(batch) * (2.0 * matrix_params(cfg) * steps + per_pos * held)


def bf16_flops_per_s(card: Dict) -> float:
    return card["sms"] * card["max_sm_clock_mhz"] * 1e6 * BF16_FLOPS_PER_CLOCK_PER_SM
