"""Config registry: ``--arch <id>`` for the LM archs (``ARCHS``: the
reference's 10 and ``PORT_ONLY_ARCHS``) beside the paper's own ConvCoTM
configurations (``configs.convcotm``).  The port's copy of
``repro/configs/__init__.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.archs import ARCHS, PORT_ONLY_ARCHS
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    applicable_shapes,
)

__all__ = [
    "ARCHS",
    "PORT_ONLY_ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "applicable_shapes",
    "get_config",
    "list_archs",
    "paired_archs",
    "reduced_config",
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def paired_archs():
    """The archs the reference holds too, sorted."""
    return sorted(a for a in ARCHS if a not in PORT_ONLY_ARCHS)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests: few layers (full cycles plus
    a tail), width 64, 4 heads, 8 experts, a 512-token vocab; the same code
    paths.  Latent attention keeps its shape at nope 16, rope 8, v 16 and
    a latent of 32; the sigmoid router takes 3 of its 8 experts, the shared
    experts ``n_shared_experts`` times an expert's width; one leading dense
    layer of 256.  An explicit layer list (Kimi Linear) becomes ``kda,
    mla, kda, mla``, with KDA heads of 16 and the short conv kept."""
    pattern = cfg.block_pattern
    n_layers = (2 * len(pattern) + 1) if pattern else 3  # cycles + tail coverage
    changes: Dict = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        rglru_lru_width=64 if cfg.rglru_lru_width else 0,
    )
    if cfg.is_moe:
        changes.update(
            n_experts=8, n_experts_per_token=2,
            d_ff_shared=64 if cfg.n_shared_experts else 0,
            router_group_size=64,
        )
    if cfg.router == "sigmoid":
        changes.update(n_experts_per_token=3,
                       d_ff_shared=cfg.n_shared_experts * changes["d_ff"])
    if cfg.first_k_dense:
        changes.update(first_k_dense=1, d_ff_dense=256)
    if cfg.is_mla:
        changes.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                       head_dim=24)
    if cfg.layer_kinds is not None:
        changes.update(n_layers=4, layer_kinds=("kda", "mla", "kda", "mla"))
    if cfg.kda_head_dim:
        changes["kda_head_dim"] = 16
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.local_window:
        changes["local_window"] = 16
    if cfg.is_encoder_decoder:
        changes["n_encoder_layers"] = 2
    if cfg.mrope_sections:
        changes["mrope_sections"] = (2, 3, 3)
    return dataclasses.replace(cfg, **changes)
