"""The model-axis operators of a tensor-parallel step
(``distributed/collectives.py``): Megatron's *f* and *g*, the all-gather
along a dim, and the row-parallel product and its partials.  At one
position (every unmeshed layer) each is the identity on its tensor, and
the row-parallel product is ``x @ w`` in the operands' dtype.

The CPU tests hold their forward and backward on devices of ``cpu``
repeated.  ``test_partial_product_on_the_card`` holds the CUDA path of
``partial_product`` (``torch.mm`` with a float32 result behind its own
autograd Function, run only for bf16 and fp16 CUDA tensors) against
``x @ w``; it needs a CUDA device and skips without one.  On the card:

    python -m pytest -q -m card tests/test_torch_model_axis.py
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import (
    copy_to_model,
    gather_from_model,
    partial_product,
    reduce_from_model,
    row_parallel,
)

CPU2 = [torch.device("cpu")] * 2


def _bf16(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_copy_to_model_sums_the_positions_gradients_once():
    x = _bf16((3, 8), 0).requires_grad_()
    parts = copy_to_model(x, CPU2)
    assert all(torch.equal(p, x) for p in parts)
    g = [_bf16((3, 8), 1), _bf16((3, 8), 2)]
    (sum((p.float() * gi.float()).sum() for p, gi in zip(parts, g))).backward()
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, (g[0].float() + g[1].float()).to(torch.bfloat16))


def test_reduce_from_model_rounds_once_and_passes_the_gradient_to_every_part():
    parts = [_bf16((4, 5), s).float().requires_grad_() for s in (3, 4, 5)]
    out = reduce_from_model(parts, "cpu", torch.bfloat16)
    assert out.dtype == torch.bfloat16
    want = ((parts[0] + parts[1]) + parts[2]).to(torch.bfloat16)
    assert torch.equal(out, want)
    g = _bf16((4, 5), 6)
    out.backward(g)
    for p in parts:
        assert p.grad.dtype == torch.float32 and torch.equal(p.grad, g.float())


def test_gather_from_model_joins_in_order_and_slices_the_gradient_back():
    parts = [torch.randn(2, n, generator=torch.Generator().manual_seed(n)).requires_grad_()
             for n in (3, 5)]
    outs = gather_from_model(parts, -1, CPU2)
    assert all(torch.equal(o, torch.cat(parts, -1)) for o in outs)
    g = [torch.randn(2, 8, generator=torch.Generator().manual_seed(10 + i)) for i in range(2)]
    sum((o * gi).sum() for o, gi in zip(outs, g)).backward()
    total = g[0] + g[1]
    assert torch.equal(parts[0].grad, total[:, :3]) and torch.equal(parts[1].grad, total[:, 3:])


def test_partial_product_keeps_float32_of_bf16_on_the_cpu_and_is_the_product_otherwise():
    x, w = _bf16((2, 3, 16), 7).requires_grad_(), _bf16((16, 6), 8).requires_grad_()
    y = partial_product(x, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.detach().float() @ w.detach().float())
    y.backward(_bf16((2, 3, 6), 9).float())
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    x32, w32 = x.detach().float(), w.detach().float()
    assert torch.equal(partial_product(x32, w32), x32 @ w32)


def test_row_parallel_sums_the_positions_float32_partials_once():
    xs = [_bf16((2, 3, 8), s).requires_grad_() for s in (14, 15)]
    ws = [_bf16((8, 5), s).requires_grad_() for s in (16, 17)]
    y = row_parallel(xs, ws, "cpu")
    assert y.dtype == torch.bfloat16
    want = (xs[0].detach().float() @ ws[0].detach().float()
            + xs[1].detach().float() @ ws[1].detach().float()).to(torch.bfloat16)
    assert torch.equal(y, want)
    y.backward(_bf16((2, 3, 5), 18))
    assert all(t.grad.dtype == torch.bfloat16 for t in xs + ws)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "fp32", "fp64"])
@pytest.mark.parametrize("op", ["copy", "reduce", "gather", "row_parallel"])
def test_one_position_is_the_identity_in_the_tensors_dtype(op, dtype):
    """At one position each operator returns its input itself (no autograd
    Function, no copy, no widening), the row-parallel product is ``x @ w``
    bit for bit in the operands' dtype, and the gradient passes straight
    through."""
    x = _bf16((2, 3, 8), 19).to(dtype).requires_grad_()
    w = _bf16((8, 5), 20).to(dtype).requires_grad_()
    cpu = [torch.device("cpu")]
    if op == "copy":
        (y,) = copy_to_model(x, cpu)
    elif op == "reduce":
        y = reduce_from_model([x], "cpu")
    elif op == "gather":
        (y,) = gather_from_model([x], -1, cpu)
    if op != "row_parallel":
        assert y is x
        return
    y = row_parallel([x], [w], "cpu")
    want = x @ w
    assert y.dtype == dtype and torch.equal(y, want)
    assert type(y.grad_fn) is type(want.grad_fn)
    g = _bf16((2, 3, 5), 21).to(dtype)
    got = torch.autograd.grad(y, (x, w), g)
    assert all(torch.equal(a, b) for a, b in zip(got, torch.autograd.grad(want, (x, w), g)))


def test_reduce_of_one_part_casts_only_to_the_dtype_asked_for():
    x = _bf16((4, 5), 22).float().requires_grad_()
    assert reduce_from_model([x], "cpu", torch.float32) is x
    y = reduce_from_model([x], "cpu", torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, x.detach().to(torch.bfloat16))
    y.backward(_bf16((4, 5), 23))
    assert x.grad.dtype == torch.float32


@pytest.mark.card
@pytest.mark.parametrize("shape", [((4, 2048, 1280), 2560), ((2, 7, 3456), 2560)],
                         ids=["h2o-w_down-half", "odd-rows"])
def test_partial_product_on_the_card(card, shape):
    """bf16 on the card: the float32 result rounds to ``x @ w`` but for
    elements within float32 rounding of a bf16 rounding boundary (at most
    one bf16 ulp apart, and few), lies within float32 accumulation of the
    float64 product, and both gradients are autograd's of ``x @ w`` on the
    same bf16 gradient, bit for bit."""
    (xs, n) = shape
    x = _bf16(xs, 11).to(card).requires_grad_()
    w = (_bf16((xs[-1], n), 12).float() / xs[-1] ** 0.5).to(torch.bfloat16).to(card)
    w.requires_grad_()
    y = partial_product(x, w)
    assert y.dtype == torch.float32 and y.shape == (*xs[:-1], n)
    ref = x.detach().double() @ w.detach().double()
    bound = xs[-1] * 2.0 ** -24 * (x.detach().double().abs() @ w.detach().double().abs())
    assert bool(((y.double() - ref).abs() <= bound).all())
    want = x.detach() @ w.detach()
    moved = y.to(torch.bfloat16) != want
    ulp = torch.nextafter(want.abs(), torch.tensor(torch.inf, device=card,
                                                   dtype=torch.bfloat16)) - want.abs()
    assert bool(((y.to(torch.bfloat16).float() - want.float()).abs() <= ulp.float()).all())
    assert float(moved.float().mean()) < 1e-3
    g = _bf16((*xs[:-1], n), 13).to(card)
    y.backward(g.float())
    x2, w2 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    (x2 @ w2).backward(g)
    assert torch.equal(x.grad, x2.grad) and torch.equal(w.grad, w2.grad)
