"""The 10 assigned architecture configs (the same values as the reference's
``repro/configs/archs.py``), and the archs the port holds alone
(:data:`PORT_ONLY_ARCHS`: Moonlight-16B-A3B and Kimi-Linear-48B-A3B),
which have no counterpart in the reference.

``--arch <id>`` resolves through the ``ARCHS`` dict via
``repro_torch.configs.get_config``.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "PORT_ONLY_ARCHS"]

# xLSTM-350M: sLSTM + mLSTM blocks, d_ff=0 -> capacity inside blocks
# (proj_factor).  7:1 mLSTM:sLSTM ratio (paper's xLSTM[7:1]); 24 layers =
# 3 cycles of 8.
XLSTM_350M = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    proj_factor=2.0,
    tie_embeddings=True,
    supports_long_context=True,   # recurrent state: O(1) decode
    sharding_profile="dp",        # 350M params: TP is pure overhead (§Perf)
)

# RecurrentGemma-2B: RG-LRU + local attention, 1 attn per 2 recurrent.
RECURRENTGEMMA_2B = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    rglru_lru_width=2560,
    conv_width=4,
    logit_softcap=30.0,
    tie_embeddings=True,
    supports_long_context=True,   # windowed attn + recurrent state
)

MISTRAL_NEMO_12B = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,       # 128k context
    supports_long_context=False,  # pure full attention -> long_500k skipped
)

H2O_DANUBE_1_8B = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    sliding_window=4096,          # llama+mistral mix with SWA
    supports_long_context=True,   # windowed KV cache is O(window)
)

H2O_DANUBE_3_4B = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,
    supports_long_context=True,
)

CODEQWEN15_7B = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,                # MHA
    d_ff=13440,
    vocab_size=92416,
    head_dim=128,
    rope_theta=1_000_000.0,
    supports_long_context=False,
)

QWEN2_MOE_A27B = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                    # routed expert hidden
    vocab_size=151936,
    head_dim=128,
    n_experts=60,
    n_experts_per_token=4,
    n_shared_experts=4,           # one fused shared expert of 4x1408
    d_ff_shared=5632,
    supports_long_context=False,
)

PHI35_MOE_42B = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    n_experts=16,
    n_experts_per_token=2,
    supports_long_context=False,
)

SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                  # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    is_encoder_decoder=True,
    modality="audio",
    supports_long_context=False,
)

QWEN2_VL_7B = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    mrope_sections=(16, 24, 24),  # pairs per (t, h, w); sums to hd/2
    rope_theta=1_000_000.0,
    modality="vision",
    supports_long_context=False,
)

# Moonlight-16B-A3B (Moonshot AI, "Muon is Scalable for LLM Training", 2025;
# huggingface.co/moonshotai/Moonlight-16B-A3B config.json, model_type
# deepseek_v3): the DeepSeek-V3 block without multi-token prediction.  MLA
# with no query low-rank (latent 512, nope 128, rope 64, v 128), a dense
# SwiGLU of 11,264 in layer 0, then 64 routed experts of 1,408 (top 6 of
# sigmoid + correction bias, normalised, x2.446; n_group 1) and 2 shared
# experts as one ungated SwiGLU of 2,816.
MOONLIGHT_16B_A3B = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                    # routed expert hidden
    vocab_size=163840,
    head_dim=192,                 # qk_nope + qk_rope
    rope_theta=50_000.0,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_experts_per_token=6,
    n_shared_experts=2,
    d_ff_shared=2816,
    first_k_dense=1,
    d_ff_dense=11264,
    router="sigmoid",
    routed_scaling=2.446,
    norm_eps=1e-5,
    supports_long_context=False,
)

# Kimi-Linear-48B-A3B (Moonshot AI, "Kimi Linear", arXiv:2510.26692;
# huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct config.json,
# model_type kimi_linear): 27 layers at d 2,304.  20 Kimi Delta Attention
# layers (32 heads of d_k = d_v = 128, short conv 4) and 7 MLA layers with
# no rotary embedding (mla_use_nope; latent 512, nope 128, rope 64, v 128)
# at 1-based 4, 8, ..., 24 and 27 (linear_attn_config.full_attn_layers);
# layer 0 a dense SwiGLU of 9,216, the others 256 routed experts of 1,024
# (top 8 of sigmoid + correction bias, renormalised, x2.446) and 1 shared.
_KIMI_MLA = (4, 8, 12, 16, 20, 24, 27)
KIMI_LINEAR_48B_A3B = ModelConfig(
    name="kimi-linear-48b-a3b",
    family="hybrid",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,
    d_ff=1024,                    # routed expert hidden
    vocab_size=163840,
    head_dim=192,                 # MLA's qk_nope + qk_rope
    rope_theta=10_000.0,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mla_rope=False,
    kda_head_dim=128,
    conv_width=4,
    layer_kinds=tuple("mla" if i + 1 in _KIMI_MLA else "kda" for i in range(27)),
    n_experts=256,
    n_experts_per_token=8,
    n_shared_experts=1,
    d_ff_shared=1024,
    first_k_dense=1,
    d_ff_dense=9216,
    router="sigmoid",
    routed_scaling=2.446,
    norm_eps=1e-5,
    supports_long_context=False,
)

ARCHS = {
    c.name: c
    for c in [
        XLSTM_350M,
        RECURRENTGEMMA_2B,
        MISTRAL_NEMO_12B,
        H2O_DANUBE_1_8B,
        H2O_DANUBE_3_4B,
        CODEQWEN15_7B,
        QWEN2_MOE_A27B,
        PHI35_MOE_42B,
        SEAMLESS_M4T_LARGE_V2,
        QWEN2_VL_7B,
        MOONLIGHT_16B_A3B,
        KIMI_LINEAR_48B_A3B,
    ]
}

#: The registered archs the reference does not hold: tests that hold the
#: port to the reference run over the others.
PORT_ONLY_ARCHS = (MOONLIGHT_16B_A3B.name, KIMI_LINEAR_48B_A3B.name)
