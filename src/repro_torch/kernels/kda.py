"""One decode step of Kimi Delta Attention's recurrence (``models/kda.py``)
on a layer's state, in place.

:func:`kda_decode_step` takes the state ``S`` [B, H, d_k, d_v] and the
step's ``q, k, g`` [B, H, d_k], ``v`` [B, H, d_v], ``beta`` [B, H], all
float32, writes ``S <- Diag(exp g) S + beta k (v - k^T Diag(exp g) S)^T``
over ``S`` and returns ``o = S^T q`` [B, H, d_v] (the new ``S``).  A CUDA
state launches ``csrc/kda_decode.cu`` on the current stream (so a CUDA
graph of the step captures it; :func:`kda_decode_cuda`, whose
``launches`` counts it); a CPU state takes :func:`kda_decode_plain`, the
same arithmetic in torch operations.  No TPU kernel is replaced: the
reference has no delta rule.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.shapes import check_cuda

__all__ = ["HEAD_DIMS", "kda_decode_cuda", "kda_decode_plain", "kda_decode_step"]

#: The head widths ``d_k = d_v`` the kernel is built for: Kimi Linear's and
#: the reduced config's.
HEAD_DIMS = (16, 128)


def _check(state, q, k, v, g, beta) -> None:
    b, h, dk, dv = state.shape
    want = {"q": (q, (b, h, dk)), "k": (k, (b, h, dk)), "g": (g, (b, h, dk)),
            "v": (v, (b, h, dv)), "beta": (beta, (b, h))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"kda_decode: {name} must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if state.dtype != torch.float32:
        raise ValueError(f"kda_decode: the state must be float32; got {state.dtype}")


def kda_decode_plain(state, q, k, v, g, beta) -> torch.Tensor:
    """The kernel's arithmetic in torch operations, ``state`` written in
    place."""
    _check(state, q, k, v, g, beta)
    state.mul_(torch.exp(g)[..., None])
    u = torch.einsum("bhk,bhkv->bhv", k, state)
    state.add_(torch.einsum("bhk,bhv->bhkv", beta[..., None] * k, v - u))
    return torch.einsum("bhk,bhkv->bhv", q, state)


def _entry():
    """The C entry point, built and loaded on first use."""
    return _build.entry("kda_decode", "kda_decode", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])


def kda_decode_cuda(state, q, k, v, g, beta) -> torch.Tensor:
    """Launch ``csrc/kda_decode.cu`` on the current stream: ``state``
    written in place, ``o`` returned.  Every operand contiguous on one
    card, ``d_k == d_v`` in :data:`HEAD_DIMS`."""
    _check(state, q, k, v, g, beta)
    dev = check_cuda("kda_decode_cuda", state, q, k, v, g, beta)
    b, h, dk, dv = state.shape
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"kda_decode_cuda takes d_k == d_v in {HEAD_DIMS}; got {dk}, {dv}")
    if not state.is_contiguous():
        raise ValueError("kda_decode_cuda writes a contiguous state in place")
    q, k, v, g, beta = (t.contiguous() for t in (q, k, v, g, beta))
    out = torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    if b * h == 0:
        return out
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(state.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                  beta.data_ptr(), out.data_ptr(), b * h, dk, dv, stream)
    _build.check("kda_decode", code)
    kda_decode_cuda.launches += 1
    return out


#: Launches of the CUDA kernel (a plain count; reset by callers).
kda_decode_cuda.launches = 0


def kda_decode_step(state, q, k, v, g, beta) -> torch.Tensor:
    """The kernel for a CUDA state, the plain version for a CPU one."""
    if state.is_cuda:
        return kda_decode_cuda(state, q, k, v, g, beta)
    return kda_decode_plain(state, q, k, v, g, beta)
