"""The Kimi Linear decode's yardstick: the model FLOPs of a call and the
KDA decode kernel's bound, worked out from the configuration (the model's
``config.json`` keys, ``num_experts`` the experts held of
``experts_routed``) and the card's facts, never from the program's code.

FLOPs are counted in the model's own form: a token costs 2 FLOPs per
matrix parameter it passes outside the experts (every layer's attention
projections, KDA's and MLA's; layer 0's dense SwiGLU; each MoE layer's
router over all its experts and its shared expert; the head; the
embedding is a lookup), 2 per parameter of the ``k * held / routed``
held experts it reaches on average (``k`` chosen of ``routed``, the held
ones' part being what this card computes), ``8 * H * d_k * d_v`` a KDA
layer (four passes over each head's state at 2 FLOPs an element: the
decay, ``k^T S``, the rank-1 update, ``S^T q``), and latent attention
over the positions it holds: ``2 * heads * (qk_nope + qk_rope) + 2 *
heads * v_head_dim`` an MLA layer and position.  The bf16 rate is
``lm_yardstick``'s.

The KDA decode kernel's bound, for one launch over ``B`` sequences: its
bytes are each head's float32 state read once and written once, ``q, k,
g`` (``d_k``), ``v`` (``d_v``) and ``beta`` read and ``o`` (``d_v``)
written, all float32; its FLOPs are ``8 * d_k * d_v`` a head, float32
fused multiply-adds on the CUDA cores (no tensor core), so they are
divided by the card's float32 rate (:data:`FP32_FLOPS_PER_CLOCK_PER_SM`).
The bound is the larger of bytes over the memory rate and FLOPs over
that rate; at the cell's shape the bytes are ~20 times the FLOPs' term,
so the bound is the memory's.
"""

from __future__ import annotations

from typing import Dict

from harness.card import HBM_BYTES_PER_S
from harness.kimi_linear_reference import layer_kinds
from harness.lm_yardstick import bf16_flops_per_s

#: float32 FLOPs per clock per SM of compute capability 9.0: 128 float32
#: lanes, a fused multiply-add 2 FLOPs (132 SMs x 1.98 GHz: the data
#: sheet's 67 TFLOPS for the H100 SXM).
FP32_FLOPS_PER_CLOCK_PER_SM = 256

__all__ = ["FP32_FLOPS_PER_CLOCK_PER_SM", "active_matrix_params", "attention_flops_per_position", "call_flops",
           "fp32_flops_per_s", "kda_bound_s", "kda_launch_bytes", "kda_launch_flops", "kda_state_flops"]


def _kda_dims(cfg: Dict):
    lac = cfg["linear_attn_config"]
    return lac["num_heads"], lac["head_dim"]


def active_matrix_params(cfg: Dict) -> float:
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    hk, dk = _kda_dims(cfg)
    kd = hk * dk
    ff, k = cfg["moe_intermediate_size"], cfg["num_experts_per_token"]
    reached = k * cfg["num_experts"] / cfg["experts_routed"]
    mla = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v) + h * v * d
    kda = 4 * d * kd + 2 * (d + kd) * dk + d * hk
    moe = d * cfg["experts_routed"] + 3 * reached * d * ff + 3 * d * ff * cfg["num_shared_experts"]
    kinds, dense = layer_kinds(cfg), cfg["first_k_dense_replace"]
    return (sum(mla if kind == "mla" else kda for kind in kinds)
            + dense * 3 * d * cfg["intermediate_size"] + (len(kinds) - dense) * moe
            + d * cfg["vocab_size"])


def attention_flops_per_position(cfg: Dict) -> int:
    h = cfg["num_attention_heads"]
    return 2 * h * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) + 2 * h * cfg["v_head_dim"]


def kda_state_flops(cfg: Dict) -> int:
    """A token's FLOPs on the KDA states of all its KDA layers."""
    hk, dk = _kda_dims(cfg)
    return layer_kinds(cfg).count("kda") * 8 * hk * dk * dk


def call_flops(cfg: Dict, batch: int, steps: int) -> float:
    """Model FLOPs of one call's ``steps`` decode steps (positions
    ``0..steps-1``) for ``batch`` sequences."""
    held = steps * (steps + 1) // 2
    per_pos = layer_kinds(cfg).count("mla") * attention_flops_per_position(cfg)
    per_token = 2.0 * active_matrix_params(cfg) + kda_state_flops(cfg)
    return float(batch) * (per_token * steps + per_pos * held)


def kda_launch_bytes(cfg: Dict, batch: int) -> int:
    hk, dk = _kda_dims(cfg)
    return 4 * batch * hk * (2 * dk * dk + 3 * dk + dk + 1 + dk)


def kda_launch_flops(cfg: Dict, batch: int) -> int:
    hk, dk = _kda_dims(cfg)
    return 8 * batch * hk * dk * dk


def kda_bound_s(cfg: Dict, batch: int, launches: int, card: Dict) -> float:
    """The least time the card could take for ``launches`` KDA decode
    launches over ``batch`` sequences."""
    return launches * max(kda_launch_bytes(cfg, batch) / HBM_BYTES_PER_S,
                          kda_launch_flops(cfg, batch) / fp32_flops_per_s(card))


def fp32_flops_per_s(card: Dict) -> float:
    return card["sms"] * card["max_sm_clock_mhz"] * 1e6 * FP32_FLOPS_PER_CLOCK_PER_SM
