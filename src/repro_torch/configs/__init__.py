"""Config registry: ``--arch <id>`` for the 10 LM archs (``ARCHS``) beside
the paper's own ConvCoTM configurations (``configs.convcotm``).  The
port's copy of ``repro/configs/__init__.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    applicable_shapes,
)

__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "applicable_shapes",
    "get_config",
    "list_archs",
    "reduced_config",
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests: few layers (full cycles plus
    a tail), width 64, 4 heads, 8 experts, a 512-token vocab; the same code
    paths."""
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
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.local_window:
        changes["local_window"] = 16
    if cfg.is_encoder_decoder:
        changes["n_encoder_layers"] = 2
    if cfg.mrope_sections:
        changes["mrope_sections"] = (2, 3, 3)
    return dataclasses.replace(cfg, **changes)
