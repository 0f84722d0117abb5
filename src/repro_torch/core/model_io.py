"""The ASIC's register image of a ConvCoTM (counterpart of
``repro/core/model_io.py``).

The chip stores (paper Sec. IV-B) the TA action signals, 272 x 128 =
34,816 bits, and the clause weights, 10 x 128 x 8 bits: 45,056 bits or
5,632 bytes.  Layout: clause-major TA-action bits, LSB-first within each
byte, literal index ascending; then class-major int8 two's-complement
weights.  The bytes equal the reference's for the same model.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cotm import TA_HALF, CoTMConfig, CoTMModel

__all__ = ["model_size_bytes", "pack_model", "unpack_model"]


def model_size_bytes(config: CoTMConfig) -> int:
    ta_bits = config.n_clauses * config.n_literals
    return (ta_bits + 7) // 8 + config.n_classes * config.n_clauses


def pack_model(model: CoTMModel, config: CoTMConfig) -> bytes:
    """Model -> register image (bytes), from either device."""
    include = model.include.cpu().numpy()                  # uint8 [C, 2o]
    if include.shape != (config.n_clauses, config.n_literals):
        raise ValueError(
            f"include is {include.shape}, config wants "
            f"({config.n_clauses}, {config.n_literals})"
        )
    flat = include.reshape(-1)
    pad = (-flat.size) % 8
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    ta_bytes = np.packbits(flat.reshape(-1, 8), axis=1, bitorder="little").reshape(-1)
    w = model.weights.cpu().numpy().astype(np.int64)
    if w.min() < -128 or w.max() > 127:
        raise ValueError("weights exceed the ASIC's int8 range")
    return ta_bytes.tobytes() + w.astype(np.int8).reshape(-1).view(np.uint8).tobytes()


def unpack_model(blob: bytes, config: CoTMConfig, device=None) -> CoTMModel:
    """Register image -> inference-only model on ``device`` (the card
    unless ``"cpu"`` is named, see :func:`repro_torch.resolve_device`): TA
    counters at the action boundary (include -> N, exclude -> N-1), since
    the chip keeps only the action bits."""
    device = resolve_device(device)
    exp = model_size_bytes(config)
    if len(blob) != exp:
        raise ValueError(f"register image is {len(blob)} bytes, expected {exp}")
    ta_bits = config.n_clauses * config.n_literals
    ta_nbytes = (ta_bits + 7) // 8
    bits = np.unpackbits(np.frombuffer(blob[:ta_nbytes], np.uint8), bitorder="little")
    include = bits[:ta_bits].reshape(config.n_clauses, config.n_literals)
    ta_state = np.where(include > 0, TA_HALF, TA_HALF - 1).astype(np.uint8)
    w = (np.frombuffer(blob[ta_nbytes:], np.uint8).view(np.int8)
         .reshape(config.n_classes, config.n_clauses).astype(np.int32))
    return CoTMModel(ta_state=torch.from_numpy(ta_state).to(device),
                     weights=torch.from_numpy(w).to(device))
