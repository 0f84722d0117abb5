"""Collectives over a :class:`~repro_torch.launch.mesh.DeviceMesh`
(counterpart of ``repro/distributed/collectives.py``).

One process drives every shard.  A shard's contribution is a tensor on
that shard's device, and a reduction is device-to-device copies and adds,
taken in a fixed shard order, so an integer reduction is exact and every
replica holds the same bits.  The reference wraps its per-shard bodies in
``shard_map`` (``shard_map_compat``, ``_shard_map``); here the per-shard
loop is written out where it runs, so neither has a counterpart.

Return convention: :func:`psum_tree`, the per-shard primitive, returns
every shard's replica; the functions that take a mesh
(:func:`tree_psum_batch`, :func:`int8_psum_shard_map`) return the reduced
value once, as the first shard along the axis holds it (the reference
returns one replicated array).

``quantize_int8`` / ``dequantize_int8`` / ``compressed_grad_sync``: per-block
int8 quantization with error feedback, float32 IEEE operations in the
reference's order (round half to even), bit for bit the reference's.

The model-axis operators of a tensor-parallel step (Megatron's *f* and
*g*), over the positions of one data shard along ``model``, each
position's tensor on its own device: :func:`copy_to_model` (identity
forward, sum backward), :func:`reduce_from_model` (sum forward, identity
backward) and :func:`gather_from_model` (concatenation forward, slice
backward).  Every sum is taken in position order, in float32 (float64
for float64 tensors), and rounded once to the tensors' dtype, so bf16
partials add no second rounding.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import DeviceMesh

__all__ = [
    "BLOCK",
    "compressed_grad_sync",
    "copy_to_model",
    "dequantize_int8",
    "gather_from_model",
    "partial_product",
    "int8_psum_shard_map",
    "psum_tree",
    "quantize_int8",
    "reduce_from_model",
    "tree_psum_batch",
]

BLOCK = 2048


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"collective leaves must be tensors; got {type(tree).__name__}")


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def _replicate(tree: Any, devices: Sequence[torch.device]) -> List[Any]:
    """``tree`` copied to each of ``devices``; a repeated device shares one
    copy, and the tree's own device takes the tree itself."""
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = _tree_map(lambda t: t.to(dev), tree)
    return [copies[dev] for dev in devices]


def psum_tree(shards: Sequence[Any]) -> List[Any]:
    """Exact all-reduce of per-shard trees (a tensor, or tuples, lists and
    dicts of tensors, one tree per shard, each on its shard's device).

    The sum is taken on the first shard's device, in shard order, then
    placed on each shard's device; returns one tree per shard.  Integer
    leaves reduce exactly, which keeps clause-sharded class sums equal to
    the unsharded evaluation bit for bit."""
    if not shards:
        raise ValueError("psum_tree needs at least one shard")
    home = _leaves(shards[0])[0].device

    def add(*parts: torch.Tensor) -> torch.Tensor:
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(home)
        return acc

    total = _tree_map(add, shards[0], *shards[1:])
    return _replicate(total, [_leaves(s)[0].device for s in shards])


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(0)``, integer leaves in int32 (``jnp.sum``'s int32 result)."""
    if x.dtype == torch.bool or (not x.dtype.is_floating_point and not x.is_complex()):
        return x.sum(0, dtype=torch.int32)
    return x.sum(0)


def _row_blocks(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} shards")
    k = x.shape[0] // n
    return [x[i * k:(i + 1) * k].to(dev) for i, dev in enumerate(devices)]


def tree_psum_batch(tree: Any, mesh: Optional[DeviceMesh] = None, axis: str = "data") -> Any:
    """Sum each leaf of a per-sample tree over its leading batch axis.

    The TM data-parallel delta reduction.  Without a mesh, ``x.sum(0)``.
    With one, the batch axis is split over the devices along ``axis``
    (``B`` must divide): each shard sums its rows on its device, and
    :func:`psum_tree` combines the partial sums exactly.  A leaf may also
    be given already split, as a list of its per-shard row blocks, each on
    its shard's device (what a data-parallel step computes).  Integer
    leaves sum in int32: cast int8 deltas first, as the reference asks.
    Returns the tree of sums as the first shard holds it.
    """
    if mesh is None:
        return _tree_map(_sum_rows, tree)
    devices = mesh.along(axis)

    def split(x):
        blocks = list(x) if isinstance(x, list) else _row_blocks(x, devices)
        if len(blocks) != len(devices):
            raise ValueError(f"{len(blocks)} row blocks for {len(devices)} shards")
        return blocks

    def over(fn, t):      # tuples and dicts are nodes; tensors and lists leaves
        if isinstance(t, dict):
            return {k: over(fn, v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(over(fn, v) for v in t)
        return fn(t)

    blocks = over(split, tree)
    partials = [over(lambda b, i=i: _sum_rows(b[i]), blocks) for i in range(len(devices))]
    return psum_tree(partials)[0]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization; returns ``(q int8 [nb, BLOCK],
    scale float32 [nb, 1])``, the scale floored at 1e-12."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    # Divisions by float32 tensors, as XLA divides (a Python scalar
    # divisor may become a multiply by its reciprocal).
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_full((), 127.0)
    scale = torch.maximum(scale, scale.new_full((), 1e-12))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compressed_grad_sync(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 compression of a gradient tree (a tensor, or
    tuples, lists and dicts of tensors).

    Returns (dequantized grads, new residual); ``residual`` has the
    structure of ``grads`` (float32)."""
    if isinstance(grads, torch.Tensor):
        gf = grads.to(torch.float32) + residual
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s, grads.shape, torch.float32)
        return deq.to(grads.dtype), gf - deq
    if isinstance(grads, dict):
        outs = {k: compressed_grad_sync(g, residual[k]) for k, g in grads.items()}
        return {k: o[0] for k, o in outs.items()}, {k: o[1] for k, o in outs.items()}
    outs = [compressed_grad_sync(g, r) for g, r in zip(grads, residual)]
    return type(grads)(o[0] for o in outs), type(grads)(o[1] for o in outs)


def int8_psum_shard_map(x, mesh: DeviceMesh, axis: str = "pod") -> torch.Tensor:
    """Int8-compressed all-reduce over one mesh axis.

    ``x`` is a tensor every shard along ``axis`` contributes (the
    reference's replicated input), or a list of per-shard contributions,
    one per device along ``axis``.  Each shard quantizes its part; the
    shards share the largest per-block scale, requantize against it so the
    int32 sum is exact, and dequantize.  Returns the result as the first
    shard holds it."""
    devices = mesh.along(axis)
    parts = list(x) if isinstance(x, list) else [x.to(d) for d in devices]
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} contributions for {len(devices)} shards")
    quant = [quantize_int8(p) for p in parts]
    s_max = quant[0][1]
    for _, s in quant[1:]:
        s_max = torch.maximum(s_max, s.to(s_max.device))
    s_maxes = _replicate(s_max, [p.device for p in parts])
    q2 = [torch.round(q.to(torch.float32) * (s / sm)).to(torch.int32)
          for (q, s), sm in zip(quant, s_maxes)]
    tot = psum_tree(q2)[0]
    return dequantize_int8(tot, s_maxes[0], parts[0].shape, parts[0].dtype)


# ---------------------------------------------------------------------------
# The model-axis operators
# ---------------------------------------------------------------------------

def _fixed_sum(parts: Sequence[torch.Tensor], home: torch.device, dtype) -> torch.Tensor:
    """``parts`` summed on ``home`` in their order, in float32 (float64 for
    float64 parts), rounded once to ``dtype``."""
    wide = torch.float64 if parts[0].dtype == torch.float64 else torch.float32
    acc = parts[0].to(device=home, dtype=wide)
    for p in parts[1:]:
        acc = acc + p.to(device=home, dtype=wide)
    return acc.to(dtype)


def _on(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: an alias on its own device, else a copy."""
    return x.view_as(x) if x.device == dev else x.to(dev)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.home, ctx.dtype = x.device, x.dtype
        return tuple(_on(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return _fixed_sum(grads, ctx.home, ctx.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, home, dtype, *parts):
        ctx.parts = [(p.device, p.dtype) for p in parts]
        return _fixed_sum(parts, home, dtype)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *(grad.to(device=d, dtype=t) for d, t in ctx.parts))


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim = dim
        ctx.parts = [(p.device, p.dtype, p.shape[dim]) for p in parts]
        return tuple(torch.cat([p.to(d) for p in parts], dim) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        out, start = [], 0
        for dev, dtype, n in ctx.parts:
            out.append(_fixed_sum([g.narrow(ctx.dim, start, n) for g in grads], dev, dtype))
            start += n
        return (None, None, *out)


class _PartialProduct(torch.autograd.Function):
    """``x @ w`` of bf16 or fp16 CUDA tensors with a float32 result (cuBLAS's
    float32 accumulator, not rounded); the backward is that of ``x @ w``
    on the gradient in the inputs' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = (x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (``w`` a matrix) as one model position's partial of a
    row-parallel product, for :func:`reduce_from_model`: accumulated and
    returned in float32 when the operands are bf16 or fp16, so the sum over
    the positions rounds once, where the unmeshed product rounds; ``x @ w``
    as it is otherwise."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return x @ w
    if x.is_cuda:
        return _PartialProduct.apply(x, w)
    return x.float() @ w.float()


def copy_to_model(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each model position's device (*f*): the same values forward;
    backward, the positions' gradients summed in position order, in
    float32, rounded once to ``x``'s dtype.  A position on ``x``'s device
    reads ``x`` itself."""
    return list(_CopyToModel.apply(x, [torch.device(d) for d in devices]))


def reduce_from_model(parts: Sequence[torch.Tensor], home, dtype=None) -> torch.Tensor:
    """The sum of the model positions' partial results on ``home`` (*g*): in
    position order, in float32, rounded once to ``dtype`` (the parts'
    dtype by default); backward, the gradient goes to every part, in its
    dtype."""
    dtype = parts[0].dtype if dtype is None else dtype
    return _ReduceFromModel.apply(torch.device(home), dtype, *parts)


def gather_from_model(parts: Sequence[torch.Tensor], dim: int,
                      devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The model positions' blocks joined along ``dim``, in position order,
    on each of ``devices`` (an all-gather; one device gathers to it alone).
    Backward, each block takes its slice of every output's gradient,
    summed over the outputs in their order, in float32."""
    return list(_GatherFromModel.apply(dim, [torch.device(d) for d in devices], *parts))
