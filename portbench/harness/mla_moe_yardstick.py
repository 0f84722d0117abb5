"""The latent-attention MoE decode's yardstick: the model FLOPs of a token
and the routed experts' bound, worked out from the configuration (the
model's ``config.json`` keys), the card's facts and the program's
routing counts, never from the program's code.

FLOPs are counted in the model's own form, not the program's absorbed
one, so the count does not depend on how the program computes: a token
costs 2 FLOPs per active matrix parameter it passes (every layer's
``Wq``, ``Wkv_a``, ``Wkv_b``, ``Wo``; layer 0's dense SwiGLU; each MoE
layer's router, its ``k`` chosen experts and its shared experts; the
head; the embedding is a lookup) plus attention over the positions it
holds: ``2 * heads * (qk_nope + qk_rope) + 2 * heads * v_head_dim`` a
layer and position (q.k and the weighted sum of v: 10,240 for
Moonlight).  The bf16 rate is ``lm_yardstick``'s.

The routed experts' bound, for one MoE layer's call with group ends
``ends`` (``P`` pairs, ``h`` experts hit): bytes are the hit experts'
three matrices and the pairs' rows in and out of each grouped product
(gate and up read ``P x d`` and write ``P x ff``, down reads ``P x ff``
and writes ``P x d``), in the configuration's dtype; FLOPs are ``2 x 3 x
d x ff`` a pair.  The bound is the larger of bytes over the memory rate
and FLOPs over the bf16 rate.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from harness.card import HBM_BYTES_PER_S
from harness.lm_yardstick import bf16_flops_per_s

__all__ = ["active_matrix_params", "attention_flops_per_position", "call_flops",
           "experts_bound_s"]

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def active_matrix_params(cfg: Dict) -> int:
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    ff, e, k = cfg["moe_intermediate_size"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    attn = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v) + h * v * d
    moe = d * e + 3 * k * d * ff + 3 * d * ff * cfg["n_shared_experts"]
    return (layers * attn + dense * 3 * d * cfg["intermediate_size"] + (layers - dense) * moe
            + d * cfg["vocab_size"])


def attention_flops_per_position(cfg: Dict) -> int:
    h = cfg["num_attention_heads"]
    return 2 * h * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) + 2 * h * cfg["v_head_dim"]


def call_flops(cfg: Dict, batch: int, steps: int) -> float:
    """Model FLOPs of one call's ``steps`` decode steps (positions
    ``0..steps-1``) for ``batch`` sequences."""
    held = steps * (steps + 1) // 2
    per_pos = cfg["num_hidden_layers"] * attention_flops_per_position(cfg)
    return float(batch) * (2.0 * active_matrix_params(cfg) * steps + per_pos * held)


def experts_bound_s(cfg: Dict, ends: Iterable[np.ndarray], card: Dict) -> float:
    """The least time the card could take for the routed experts' grouped
    products of every call whose group ends are in ``ends``."""
    d, ff = cfg["hidden_size"], cfg["moe_intermediate_size"]
    size = _BYTES[cfg["torch_dtype"]]
    total = 0.0
    for e in ends:
        e = np.asarray(e, dtype=np.int64)
        pairs, hit = int(e[-1]), int((np.diff(e, prepend=0) > 0).sum())
        nbytes = size * (hit * 3 * d * ff + 3 * pairs * (d + ff))
        total += max(nbytes / HBM_BYTES_PER_S, 2.0 * 3 * d * ff * pairs / bf16_flops_per_s(card))
    return total
