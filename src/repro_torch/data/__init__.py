from repro_torch.data.datasets import (
    get_dataset,
    load_idx,
    load_mnist_like,
    noisy_xor_2d,
    synthetic_glyphs,
)
from repro_torch.data.pipeline import (
    DoubleBufferedLoader,
    PipelineState,
    batches,
    booleanize_split,
    epoch_permutation,
    literals_host,
    pack_literals_host,
    preprocess_for_serving,
)

__all__ = [
    "DoubleBufferedLoader",
    "PipelineState",
    "batches",
    "booleanize_split",
    "epoch_permutation",
    "get_dataset",
    "literals_host",
    "load_idx",
    "load_mnist_like",
    "noisy_xor_2d",
    "pack_literals_host",
    "preprocess_for_serving",
    "synthetic_glyphs",
]
