"""One decode step of grouped-query attention on a KV cache
(``models/attention.py:decode_attention``).

:func:`gqa_decode_cuda` takes the step's queries ``q`` [B, KV, G, hd], the
caches ``k``, ``v`` [B, KV, S, hd] (the new key and value already written
at slot ``pos % S``), the position and the window, and returns the
attention output [B, KV, G, hd] in the values' dtype: float32 scores and
softmax over the visible slots, each weight rounded to the values' dtype
before it weights them, the sums in float32 and rounded once.  A slot is
visible where its absolute position ``pos - (pos - slot) mod S`` is at
least 0 and, with a window, within ``window`` of ``pos``
(:func:`visible`).  It launches ``csrc/gqa_decode.cu`` on the current
stream, with ``pos`` an int or a 0-d int64 tensor read on the card, so a
CUDA graph of the step captures it (``launches`` counts every launch).
:func:`gqa_decode_split_cuda` attends over a cache held in blocks along
``model``, each on its own card: a launch a block for its maxima and sums,
their combine, and a launch a block for its weighted values, summed in
order as ``attention._split_softmax`` sums them.  Both take bf16, fp16 and
float32 caches with a head of 8 to :data:`MAX_HEAD_DIM` values in 8s and
raise on anything else.  :func:`gqa_decode_plain` is the whole cache's
arithmetic in torch operations, the plain ``_sdpa`` of the attention
module with its mask.  No TPU kernel is replaced: the reference attends
with XLA's operations.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.distributed.collectives import reduce_from_model
from repro_torch.kernels import _build
from repro_torch.kernels.shapes import check_cuda
from repro_torch.models.layers import wide

__all__ = ["DTYPES", "MAX_HEAD_DIM", "gqa_decode_cuda", "gqa_decode_plain",
           "gqa_decode_split_cuda", "on_card", "scratch_floats", "visible"]

#: The cache dtypes the kernel reads, in the C entry point's order.
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
#: The widest head it takes; a head is a multiple of 8 values.
MAX_HEAD_DIM = 256
#: The kernel's modes (``csrc/gqa_decode.cu``).
WHOLE, STATS, PART = 0, 1, 2


def visible(pos, slots: torch.Tensor, s_cache: int, window: Optional[int]) -> torch.Tensor:
    """Which of the ``slots`` of a ring of ``s_cache`` position ``pos`` (an
    int or a 0-d integer tensor) sees: bool, ``slots``' shape.  A slot holds
    absolute position ``pos - (pos - slot) mod s_cache``, the last written
    there."""
    abs_pos = pos - (pos - slots) % s_cache
    ok = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        ok &= pos - abs_pos < window
    return ok


def gqa_decode_plain(q, k, v, pos, window: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in torch operations, in the order of
    ``attention._sdpa``: [B, KV, G, hd] in the values' dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bkgqh,bksh->bkgqs", wide(q[:, :, :, None]), wide(k)) * scale
    slots = torch.arange(k.shape[2], device=k.device)
    scores = scores.masked_fill(~visible(pos, slots, k.shape[2], window), float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bksh->bkgqh", w.to(v.dtype), v)[:, :, :, 0]


def on_card(t: torch.Tensor) -> bool:
    """Whether ``decode_attention`` gives a cache block to the kernel."""
    return t.is_cuda


def _check(name: str, q, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
           window: Optional[int]) -> None:
    b, kv, g, hd = q.shape
    for k, v in zip(ks, vs):
        if k.dim() != 4 or k.shape != v.shape or tuple(k.shape[:2]) != (b, kv) \
                or k.shape[3] != hd:
            raise ValueError(f"{name}: q {tuple(q.shape)} against caches {tuple(k.shape)} "
                             f"and {tuple(v.shape)}")
        if k.dtype not in DTYPES or not q.dtype == k.dtype == v.dtype:
            raise ValueError(f"{name} takes bf16, fp16 or float32 alike; got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
    if not 8 <= hd <= MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"{name} takes a head of 8 to {MAX_HEAD_DIM} values in 8s; got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be at least 1; got {window}")


def _entry(symbol: str = "gqa_decode"):
    """A C entry point, built and loaded on first use."""
    if symbol == "gqa_decode_scratch":
        return _build.entry("gqa_decode", symbol, [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    return _build.entry("gqa_decode", symbol, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])


def scratch_floats(g: int, hd: int, n_max: int) -> int:
    """The float32 scratch a (sequence, kv head) needs for its scores [g,
    n_max], as the C entry point sizes its launch: 0 where they fit in
    shared memory."""
    n = _entry("gqa_decode_scratch")(g, hd, n_max)
    if n < 0:
        raise ValueError(f"gqa_decode: no launch for {g} heads of {hd} over {n_max} slots")
    return n


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte boundary, as the kernel reads it."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


def _launch(mode: int, q, k, v, out, stats, pos, s_cache: int, first: int,
            window: Optional[int]) -> None:
    """One launch of the kernel over the block ``k``, ``v`` (slots ``first``
    .. of a ring of ``s_cache``), on its card's current stream."""
    dev = check_cuda("gqa_decode", q, k, v)
    b, kv, g, hd = q.shape
    k, v, q = _aligned(k), _aligned(v), q.contiguous()
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1:
            raise ValueError("gqa_decode: a tensor position must be one int64")
        pos = pos.to(dev)
        pos_ptr, pos_val = pos.data_ptr(), 0
    else:
        if pos < 0:
            raise ValueError(f"gqa_decode: position {pos} < 0")
        pos_ptr, pos_val = None, int(pos)
    n_max = s_cache if window is None else min(s_cache, window)
    if b * kv == 0:
        return
    floats = scratch_floats(g, hd, n_max)
    scratch = (torch.empty((b * kv * floats,), dtype=torch.float32, device=dev)
               if floats else None)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if out is None else out.data_ptr(),
                  None if stats is None else stats.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), pos_ptr, pos_val, b * kv, g,
                  s_cache, k.shape[2], first, hd, n_max, hd ** -0.5, DTYPES.index(k.dtype), mode,
                  stream)
    _build.check("gqa_decode", code)
    gqa_decode_cuda.launches += 1


def gqa_decode_cuda(q, k, v, pos, window: Optional[int] = None) -> torch.Tensor:
    """The attention of ``q`` [B, KV, G, hd] over the whole caches ``k``,
    ``v`` [B, KV, S, hd] on its card: [B, KV, G, hd] in the values' dtype.
    All bf16, fp16 or float32 alike; ``pos`` an int or a 0-d int64
    tensor."""
    _check("gqa_decode_cuda", q, [k], [v], window)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(WHOLE, q, k, v, out, None, pos, k.shape[2], 0, window)
    return out


def gqa_decode_split_cuda(q, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                          firsts: Sequence[int], s_cache: int, pos,
                          window: Optional[int] = None) -> torch.Tensor:
    """The attention of ``q`` [B, KV, G, hd] over a ring of ``s_cache``
    slots held in blocks, ``ks[i]``, ``vs[i]`` [B, KV, S_i, hd] holding
    slots ``firsts[i]`` .. on their own cards: [B, KV, G, hd] in the values'
    dtype on ``q``'s card.  Each block's maxima and sums of exponentials
    (a stats launch) are combined on ``q``'s card, in block order; each
    block's weights, normalised by the combined maxima and totals and
    rounded to the values' dtype, weight its values in float32 (a part
    launch), and the parts are summed in order and rounded once."""
    _check("gqa_decode_split_cuda", q, ks, vs, window)
    home = q.device
    stats = []
    for k, v, first in zip(ks, vs, firsts):
        st = torch.empty((*q.shape[:3], 2), dtype=torch.float32, device=k.device)
        _launch(STATS, q.to(k.device), k, v, None, st, pos, s_cache, first, window)
        stats.append(st)
    top = stats[0][..., 0].to(home)
    for st in stats[1:]:
        top = torch.maximum(top, st[..., 0].to(home))
    total = reduce_from_model([st[..., 1] * torch.exp(st[..., 0] - top.to(st.device))
                               for st in stats], home)
    both = torch.stack([top, total], -1)
    parts = []
    for k, v, first in zip(ks, vs, firsts):
        out = torch.empty(q.shape, dtype=torch.float32, device=k.device)
        _launch(PART, q.to(k.device), k, v, out, both.to(k.device), pos, s_cache, first, window)
        parts.append(out)
    return reduce_from_model(parts, home, dtype=vs[0].dtype)


#: Launches of the CUDA kernel by either wrapper (a plain count; reset by
#: callers).
gqa_decode_cuda.launches = 0
