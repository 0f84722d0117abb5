"""The 10 assigned architecture configs (the same values as the reference's
``repro/configs/archs.py``).

``--arch <id>`` resolves through the ``ARCHS`` dict via
``repro_torch.configs.get_config``.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS"]

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
    ]
}
