"""Config dataclasses: model architecture, input shapes, run settings.

The port's copy of ``repro/configs/base.py``: the same fields and values,
with ``dtype`` a torch dtype (``torch.bfloat16`` by default).  Fields the
reference lacks (latent attention and its NoPE switch, leading dense
layers, the sigmoid router, the experts a chip holds, Kimi Delta
Attention, an explicit list of layer kinds) default to what the
reference's archs compute, so every arch both packages hold is the same
config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "applicable_shapes", "TrainConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (one per assigned arch)."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- attention variants ---
    sliding_window: Optional[int] = None      # SWA (h2o-danube)
    local_window: Optional[int] = None        # local attention (recurrentgemma)
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    logit_softcap: Optional[float] = None     # recurrentgemma final softcap

    # --- latent attention (MLA, DeepSeek-V2/V3); head_dim is nope + rope ---
    kv_lora_rank: int = 0             # > 0: one latent of this width a position is cached
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0         # one rotary key shared by the heads
    v_head_dim: int = 0
    mla_rope: bool = True             # False: NoPE, the rope part of q and k left unrotated

    # --- Kimi Delta Attention (KDA, arXiv:2510.26692); n_heads heads ---
    kda_head_dim: int = 0             # d_k = d_v of a KDA head; conv_width taps of short conv

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_shared: int = 0              # shared-expert hidden size
    router_group_size: int = 512      # dispatch group (tokens)
    capacity_factor: float = 1.25
    first_k_dense: int = 0            # leading layers with a dense SwiGLU of d_ff_dense
    d_ff_dense: int = 0
    # softmax: top-k of the softmax, capacity-bounded dispatch, the shared
    # expert behind a sigmoid mix gate (Qwen2-MoE, Phi-3.5-MoE); sigmoid:
    # top-k of sigmoid + router_bias, the chosen scores normalised and scaled
    # by routed_scaling, dropless, the shared expert ungated (DeepSeek-V3).
    router: str = "softmax"
    routed_scaling: float = 1.0
    # The experts this chip holds: ids first_expert_held .. + n_experts_held
    # - 1 of the router's n_experts (0: all of them).  The router keeps its
    # n_experts outputs; only the held experts' part of the result is added.
    n_experts_held: int = 0
    first_expert_held: int = 0

    # --- recurrent families ---
    block_pattern: Optional[Tuple[str, ...]] = None  # cycled: attn|mlstm|slstm|rglru
    # Every layer's kind in order, where the layout is no one period (Kimi
    # Linear: kda and mla); None: block_pattern, or all 'mla' for MLA archs.
    layer_kinds: Optional[Tuple[str, ...]] = None
    proj_factor: float = 2.0          # xLSTM mLSTM up-projection
    conv_width: int = 4               # temporal conv width (RG-LRU; KDA's short conv)
    rglru_lru_width: int = 0          # 0 -> d_model

    # --- encoder-decoder / frontends ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    modality: Optional[str] = None    # 'audio' | 'vision' | None
    frontend_fraction: float = 0.25   # fraction of seq taken by stub frontend embeds

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # Sharding profile for train/prefill ('tp' default, 'dp' for small
    # archs) and PaLM-style parallel attention+MLP blocks; the profile is
    # read by the sharding half of the LM substrate.
    sharding_profile: str = "tp"
    use_parallel_block: bool = False
    dtype: Any = torch.bfloat16
    supports_long_context: bool = False  # sub-quadratic decode path exists

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def experts_held(self) -> int:
        """How many of the router's experts this chip holds."""
        return self.n_experts_held or self.n_experts

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i`` has experts (the leading dense ones have not)."""
        return self.is_moe and i >= self.first_k_dense

    def pattern_for_layer(self, i: int) -> str:
        if self.layer_kinds is not None:
            return self.layer_kinds[i]
        if self.is_mla:
            return "mla"
        if self.block_pattern is None:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (matmul + embedding params; norms, the
        shared expert's mix gate, the router's bias and KDA's conv taps,
        decay and bias vectors are not counted).  An MoE layer counts the
        experts held (:attr:`experts_held`) and the router's full width."""
        d, hd = self.d_model, self.head_dim
        att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        mlp = 3 * d * self.d_ff
        if self.is_moe:
            mlp = self.experts_held * 3 * d * self.d_ff + (
                3 * d * self.d_ff_shared if self.n_shared_experts else 0
            ) + d * self.n_experts
        per_layer = 0
        for i in range(self.n_layers):
            kind = self.pattern_for_layer(i)
            if kind == "attn":
                per_layer += att + mlp
            elif kind in ("mla", "kda"):
                h, r, rope = self.n_heads, self.kv_lora_rank, self.qk_rope_head_dim
                if kind == "mla":
                    per_layer += (d * h * hd + d * (r + rope)
                                  + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                                  + h * self.v_head_dim * d)
                else:       # q, k, v, the decay's and the gate's low ranks, beta, out
                    kd = h * self.kda_head_dim
                    per_layer += 4 * d * kd + 2 * (d + kd) * self.kda_head_dim + d * h
                per_layer += mlp if self.is_moe_layer(i) else 3 * d * self.d_ff_dense
            elif kind == "rglru":
                w = self.rglru_lru_width or d
                per_layer += 2 * d * w + w * d + self.conv_width * w + 2 * w + mlp
            elif kind == "mlstm":
                up = int(d * self.proj_factor)
                per_layer += 2 * d * up + 3 * up * up // max(self.n_heads, 1) + up * d
            elif kind == "slstm":
                per_layer += 4 * d * d + mlp if self.d_ff else 4 * d * d + 2 * d * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            per_layer += self.n_encoder_layers * (att + mlp + att)  # enc + cross-attn
        return per_layer + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-active experts; with a
        share of the experts held, the ``k * held / n_experts`` of them a
        token reaches on average, rounded down)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        moe_layers = self.n_layers - self.first_k_dense
        held, e = self.experts_held, self.n_experts
        inactive = held * (e - self.n_experts_per_token) * 3 * d * self.d_ff * moe_layers // e
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                          # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the four assigned shapes run for this arch: long_500k
    needs a sub-quadratic decode path (SSM, hybrid, SWA), so pure
    full-attention archs skip it."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return tuple(names)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run settings for an LM training run."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1_000
    microbatches: int = 1              # gradient accumulation
    remat: str = "full"                # 'none' | 'full'
    grad_compression: bool = False     # int8 + error feedback on pod axis
    checkpoint_every: int = 200
    seed: int = 0
