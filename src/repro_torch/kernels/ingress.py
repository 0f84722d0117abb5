"""Ingress-pack kernel: booleanized images -> packed patch literals.

Replaces the TPU kernel ``src/repro/kernels/ingress.py:ingress_pack_pallas``
with the CUDA kernel ``csrc/ingress_pack.cu`` (its source note gives the
bound and the design).  :func:`ingress_pack_cuda` launches it;
:func:`ingress_pack_plain` is the plain PyTorch version of the same
function (patch gather -> literals -> pack), used on the CPU and as the
kernel's yardstick on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.patches import (
    PatchSpec,
    extract_patch_features,
    make_literals,
    pack_bits,
)
from repro_torch.kernels import _build

__all__ = ["ingress_pack_cuda", "ingress_pack_plain", "shared_bytes"]

#: Shared memory one block may use on Hopper: the image's row bitmasks
#: and the output tile of :func:`shared_bytes` must fit.
MAX_SHARED_BYTES = 232448
#: Words of the kernel's shared output tile (``kTileWords``): an image
#: whose P*W words exceed it is done in chunks of whole patches.
TILE_WORDS = 12288


def shared_bytes(spec: PatchSpec) -> int:
    """Dynamic shared memory of one launch, as the C entry point sizes it:
    Y rows of ceil(X / 32) + 1 words, and a tile of ``chunk`` patches of W
    words (all P when they fit :data:`TILE_WORDS`, else as many whole
    patches as fit, at least one)."""
    p, w = spec.n_patches, spec.n_words
    chunk = p if p * w <= TILE_WORDS else max(TILE_WORDS // w, 1)
    return 4 * (spec.image_y * ((spec.image_x + 31) // 32 + 1) + chunk * w)


def ingress_pack_plain(bool_images: torch.Tensor, spec: PatchSpec) -> torch.Tensor:
    """uint8 0/1 ``[B, Y, X]`` -> int32 words ``[B, P, W]`` in plain PyTorch."""
    feats = extract_patch_features(bool_images, spec)
    return pack_bits(make_literals(feats), spec.n_words)


def _entry():
    """The C entry point, built and loaded on first use."""
    return _build.entry("ingress_pack", "ingress_pack",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


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


def ingress_pack_cuda(bool_images: torch.Tensor, spec: PatchSpec) -> torch.Tensor:
    """Launch the CUDA ingress-pack kernel on a CUDA uint8 0/1 ``[B, Y, X]``
    tensor; returns int32 ``[B, P, W]`` on the same card."""
    _check_spec(bool_images, spec)
    if not bool_images.is_cuda:
        raise ValueError("ingress_pack_cuda needs a CUDA tensor")
    smem = shared_bytes(spec)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"geometry needs {smem} bytes of shared memory per block; the "
            f"kernel has {MAX_SHARED_BYTES}"
        )
    imgs = bool_images.contiguous()
    b = imgs.shape[0]
    out = torch.empty(
        (b, spec.n_patches, spec.n_words), dtype=torch.int32, device=imgs.device
    )
    if b == 0:
        return out
    fn = _entry()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = fn(
            imgs.data_ptr(), out.data_ptr(), b, spec.image_y, spec.image_x,
            spec.window_y, spec.window_x, spec.stride_y, spec.stride_x, stream,
        )
    _build.check("ingress_pack", code)
    ingress_pack_cuda.launches += 1
    return out


#: Launches of the CUDA kernel (a plain count; reset by callers).
ingress_pack_cuda.launches = 0
