"""The LM substrate's models: the port's copy of ``repro/models/``.

Declarations and parameter trees (``base``), shared layers, attention,
MoE, RG-LRU, xLSTM, the decoder-only assembler (``transformer``) and the
encoder-decoder (``encdec``), in plain PyTorch.
"""

from repro_torch.models.base import (
    ParamDecl,
    ParamTree,
    abstract_params,
    init_params,
    param_bytes,
    param_count,
)

__all__ = [
    "ParamDecl",
    "ParamTree",
    "abstract_params",
    "init_params",
    "param_bytes",
    "param_count",
]
