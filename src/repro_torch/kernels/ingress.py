"""Ingress-pack kernel: images -> packed patch literals.

Replaces the TPU kernel ``src/repro/kernels/ingress.py:ingress_pack_pallas``
with the CUDA kernel ``csrc/ingress_pack.cu`` (its source note gives the
bound and the design), in two booleanize modes:

  * :func:`ingress_pack_cuda` takes booleanized uint8 0/1 images;
    :func:`ingress_pack_plain` is the plain PyTorch version of the same
    function (patch gather -> literals -> pack);
  * :func:`ingress_pack_adaptive_cuda` takes raw uint8 pixels and
    booleanizes them in the kernel with the adaptive Gaussian threshold;
    :func:`ingress_pack_adaptive_plain` is the plain composition
    (:func:`~repro_torch.core.booleanize.adaptive_gaussian_booleanize`,
    then :func:`ingress_pack_plain`).

The plain versions run on the CPU and are the kernels' yardsticks on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.booleanize import adaptive_gaussian_booleanize, gaussian_kernel1d
from repro_torch.core.patches import (
    PatchSpec,
    extract_patch_features,
    make_literals,
    pack_bits,
)
from repro_torch.kernels import _build

__all__ = [
    "MAX_TAPS",
    "ingress_pack_adaptive_cuda",
    "ingress_pack_adaptive_plain",
    "ingress_pack_cuda",
    "ingress_pack_plain",
    "shared_bytes",
]

#: Shared memory one block may use on Hopper: the image's row bitmasks
#: and the output tile of :func:`shared_bytes` must fit.
MAX_SHARED_BYTES = 232448
#: Words of the kernel's shared output tile (``kTileWords``): an image
#: whose P*W words exceed it is done in chunks of whole patches.
TILE_WORDS = 12288
#: Taps of the adaptive mode's Gaussian window that the launch's
#: parameters hold (``kMaxTaps``): the largest ``block_size`` it takes.
MAX_TAPS = 63


def shared_bytes(spec: PatchSpec, adaptive: bool = False) -> int:
    """Dynamic shared memory of one launch, as the C entry point sizes it:
    Y rows of ceil(X / 32) + 1 words, a tile of ``chunk`` patches of W
    words (all P when they fit :data:`TILE_WORDS`, else as many whole
    patches as fit, at least one), and in the adaptive mode two float32
    planes of Y x X (the pixels and the Gaussian's Y pass)."""
    p, w = spec.n_patches, spec.n_words
    chunk = p if p * w <= TILE_WORDS else max(TILE_WORDS // w, 1)
    planes = 2 * spec.image_y * spec.image_x if adaptive else 0
    return 4 * (spec.image_y * ((spec.image_x + 31) // 32 + 1) + chunk * w + planes)


def ingress_pack_plain(bool_images: torch.Tensor, spec: PatchSpec) -> torch.Tensor:
    """uint8 0/1 ``[B, Y, X]`` -> int32 words ``[B, P, W]`` in plain PyTorch."""
    feats = extract_patch_features(bool_images, spec)
    return pack_bits(make_literals(feats), spec.n_words)


def ingress_pack_adaptive_plain(images: torch.Tensor, spec: PatchSpec, block_size: int = 11,
                                c: float = 2.0) -> torch.Tensor:
    """Raw uint8 ``[B, Y, X]`` -> int32 words ``[B, P, W]`` in plain
    PyTorch: the adaptive Gaussian booleanize, then the pack."""
    return ingress_pack_plain(adaptive_gaussian_booleanize(images, block_size, c), spec)


_ARGTYPES = {
    "ingress_pack": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "ingress_pack_adaptive": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p],
}


def _entry(symbol: str = "ingress_pack"):
    """The C entry point ``symbol``, built and loaded on first use."""
    return _build.entry("ingress_pack", symbol, _ARGTYPES[symbol])


@functools.lru_cache(maxsize=None)
def _taps(block_size: int) -> ctypes.Array:
    """The window's float32 taps as a C array, made once per size."""
    return (ctypes.c_float * block_size)(*gaussian_kernel1d(block_size).tolist())


def _check_spec(bool_images: torch.Tensor, spec: PatchSpec) -> None:
    if spec.channels != 1 or spec.therm_bits != 1:
        raise ValueError("ingress kernel supports Z=U=1 geometries only")
    spec.validate()
    if bool_images.dim() != 3 or tuple(bool_images.shape[1:]) != (
        spec.image_y, spec.image_x
    ):
        raise ValueError(
            f"images must be [B, {spec.image_y}, {spec.image_x}], got "
            f"{list(bool_images.shape)}"
        )
    if bool_images.dtype != torch.uint8:
        raise TypeError(f"images must be uint8, got {bool_images.dtype}")


def _launch(symbol: str, images: torch.Tensor, spec: PatchSpec, smem: int,
            *mode_args) -> torch.Tensor:
    if not images.is_cuda:
        raise ValueError(f"{symbol}_cuda needs a CUDA tensor")
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"geometry needs {smem} bytes of shared memory per block; the "
            f"kernel has {MAX_SHARED_BYTES}"
        )
    imgs = images.contiguous()
    b = imgs.shape[0]
    out = torch.empty(
        (b, spec.n_patches, spec.n_words), dtype=torch.int32, device=imgs.device
    )
    if b == 0:
        return out
    fn = _entry(symbol)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = fn(
            imgs.data_ptr(), out.data_ptr(), b, spec.image_y, spec.image_x,
            spec.window_y, spec.window_x, spec.stride_y, spec.stride_x, *mode_args, stream,
        )
    _build.check(symbol, code)
    return out


def ingress_pack_cuda(bool_images: torch.Tensor, spec: PatchSpec) -> torch.Tensor:
    """Launch the CUDA ingress-pack kernel on a CUDA uint8 0/1 ``[B, Y, X]``
    tensor; returns int32 ``[B, P, W]`` on the same card."""
    _check_spec(bool_images, spec)
    out = _launch("ingress_pack", bool_images, spec, shared_bytes(spec))
    ingress_pack_cuda.launches += 1
    return out


def ingress_pack_adaptive_cuda(images: torch.Tensor, spec: PatchSpec, block_size: int = 11,
                               c: float = 2.0) -> torch.Tensor:
    """Launch the CUDA ingress-pack kernel in its adaptive mode on a CUDA
    uint8 ``[B, Y, X]`` tensor of raw pixels; returns int32 ``[B, P, W]``
    on the same card, bit for bit :func:`ingress_pack_adaptive_plain`'s."""
    _check_spec(images, spec)
    if block_size % 2 != 1 or not 1 <= block_size <= MAX_TAPS:
        raise ValueError(
            f"block_size must be odd and at most {MAX_TAPS} (the taps the launch "
            f"holds), got {block_size}"
        )
    out = _launch("ingress_pack_adaptive", images, spec, shared_bytes(spec, adaptive=True),
                  block_size, ctypes.cast(_taps(block_size), ctypes.c_void_p), float(c))
    ingress_pack_adaptive_cuda.launches += 1
    return out


#: Launches of the CUDA kernel in each mode (plain counts; reset by callers).
ingress_pack_cuda.launches = 0
ingress_pack_adaptive_cuda.launches = 0
