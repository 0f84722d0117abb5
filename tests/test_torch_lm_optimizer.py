"""Port vs reference: AdamW with float32 masters, the schedule and the norm.

``adamw_update`` takes the *same* gradients on both sides, the reference's
own (``jax.grad`` of its loss at its current weights), carried across by
``convert.lm_state_from_arrays``: the parameters, the moments and the
masters agree over 3 steps within 1e-6 relative, with float32 and with
bfloat16 weights (bf16 weights within one bf16 rounding of their masters).
End-to-end parameters are not compared: Adam's first step moves a weight
by about ``lr * sign(g)``, so a gradient within rounding of zero could
move it by ``2 * lr`` between the packages; the train step is compared by
its losses (``test_torch_lm_train.py``).  The schedule and the norm agree
with the reference's; the reference's optimizer tests
(``tests/test_distributed.py``: the quadratic, the schedule's shape, the
clip) hold in the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_pair import batch, configs, f32, models, to_jax

from repro.configs.base import TrainConfig as JTrainConfig
from repro.train import optimizer as jopt
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_state_from_arrays, lm_state_to_arrays
from repro_torch.train.optimizer import (
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)

RTOL = 1e-6
KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1)


@functools.lru_cache(maxsize=None)
def j_grad(jc):
    return jax.jit(jax.grad(j_make_loss_fn(jc, remat=False)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _close(got, want, name, rtol=RTOL):
    """Elementwise within ``rtol`` of the reference, and within ``rtol`` of
    the leaf's largest entry where the reference is near zero."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(f32(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_on_the_same_gradients(dtype):
    jc, tc = configs("h2o-danube-1.8b", dtype)
    params, model = models(jc, tc)
    jt, tt = JTrainConfig(**KW), TrainConfig(**KW)
    jstate, tstate = jopt.init_opt_state(params), init_opt_state(model)
    jupdate = jax.jit(functools.partial(jopt.adamw_update, tcfg=jt))
    for step in range(3):
        grads = j_grad(jc)(params, to_jax(batch(jc, b=2, s=16, seed=10 + step), jc))
        tgrads = lm_state_from_arrays(tc, {"g": jax.tree.map(np.asarray, grads)},
                                      device="cpu")["g"]
        assert all(g.dtype == p.dtype for (_, p), g in zip(model.named_parameters(),
                                                           tgrads.values()))
        params, jstate, jm = jupdate(params, grads, jstate)
        model, tstate, tm = adamw_update(model, tgrads, tstate, tt)
        assert int(tstate.step) == int(jstate.step) == step + 1
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        _close(tm["lr"], jm["lr"], "lr")
        got = lm_state_to_arrays({"params": model, "opt": tstate}, tc)
        for part in ("m", "v", "master"):
            ref = dict(_leaves(jax.tree.map(np.asarray, getattr(jstate, part))))
            for name, t in _leaves(getattr(got["opt"], part)):
                assert t.dtype == torch.float32, name
                _close(t, ref[name], f"{part}{name}")
        ref = dict(_leaves(jax.tree.map(np.asarray, params)))
        masters = dict(_leaves(got["opt"].master))
        for name, p in _leaves(got["params"]):
            assert str(p.dtype) == f"torch.{ref[name].dtype.name}", name
            # each package's weight is its master rounded to the weight's dtype
            assert torch.equal(p, masters[name].to(p.dtype)), name
            _close(p, ref[name], f"params{name}",
                   rtol=RTOL if p.dtype == torch.float32 else 2.0 ** -8)


def test_master_is_a_copy_of_fp32_params():
    p = {"w": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)}
    opt = init_opt_state(p)
    assert opt.master["w"].data_ptr() != p["w"].data_ptr()
    assert opt.master["b"].dtype == torch.float32 and opt.step.dtype == torch.int32
    adamw_update(p, {"w": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)}, opt,
                 TrainConfig(warmup_steps=1))
    assert not torch.equal(p["w"], torch.ones(3))


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 8), (0, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    for step in sorted({0, 1, warmup, (warmup + total) // 2, total, total + 3}):
        want = jopt.lr_schedule(jnp.int32(step), JTrainConfig(**kw))
        got = lr_schedule(torch.tensor(step, dtype=torch.int32), TrainConfig(**kw))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL, err_msg=str(step))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": (rng.standard_normal(300) * 1e3).astype(np.float32),
              "c": rng.standard_normal((4, 4)).astype(np.float32)}
    want = jopt.global_norm({**arrays, "c": jnp.asarray(arrays["c"], jnp.bfloat16)})
    got = global_norm({"a": torch.from_numpy(arrays["a"]), "b": torch.from_numpy(arrays["b"]),
                       "c": torch.from_numpy(arrays["c"]).to(torch.bfloat16)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


# The reference's own optimizer tests (tests/test_distributed.py), in the port.

def test_adamw_minimizes_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    for _ in range(150):
        params, opt, _ = adamw_update(params, {"w": 2 * params["w"]}, opt, tcfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_lr_schedule_shape():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4, rel=1e-3)
    assert lrs[2] == pytest.approx(1e-3, rel=1e-2)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=0.05)


def test_grad_clip_caps_update():
    tcfg = TrainConfig(learning_rate=1.0, grad_clip=1.0, warmup_steps=0, weight_decay=0.0,
                       total_steps=10)
    params = {"w": torch.zeros(4)}
    opt = init_opt_state(params)
    _, opt2, m = adamw_update(params, {"w": torch.full((4,), 1e6)}, opt, tcfg)
    assert isinstance(opt2, OptState)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    # post-clip first moment norm bounded by clip value
    assert float(torch.linalg.norm(opt2.m["w"])) <= 1.0 * (1 - tcfg.beta1) * 1.01
