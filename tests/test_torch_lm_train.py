"""Port vs reference: the LM training path at reduced size, on the CPU.

The losses (``lm_loss``, ``encdec_loss``) and their gradients, for every
arch in float32 and for a dense, an MoE and the encoder-decoder arch in
bfloat16, against the reference's ``jax.value_and_grad`` (``remat=False``,
jitted once per config).  The fixed tolerances hold on weights of each
layer's own fan-in (``model_decls(cfg, fan_in=True)``) carried to the
reference; float32 is held beside them on the reference's own draws,
whose init makes some gradients ill-conditioned.  Each gradient leaf is
carried to the reference's layout by ``convert.lm_state_to_arrays``.
Remat on equals remat off in the port.
Then ``make_train_step`` against the reference's over 3 steps (losses),
``synthetic_lm_batch`` against the reference's arrays, ``run_training``
and its checkpoint resume, the launcher, and a train state crossing
between the two packages' checkpoints both ways.

xLSTM is held on the reference's own 3-layer stack (``tests/test_models.py``),
as ``test_torch_lm_models.py`` explains: deeper, on weights of the
reference's scale, its forward moves by ~1 under a 1e-7 relative nudge of
the weights in either package.  RecurrentGemma's full reduced depth (one
cycle of three and a tail of two) compiles in seconds without the
reference's remat scan, so it is held whole.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_pair import (
    ARCH_NAMES,
    batch,
    configs,
    f32,
    models,
    np_leaf,
    ref_params,
    to_jax,
    to_torch,
)

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import restore_pytree as j_restore
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import train as jlaunch
from repro.train.train_step import init_train_state as j_init_state
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.checkpoint.checkpointer import Checkpointer, restore_pytree, save_pytree
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_state_from_arrays, lm_state_to_arrays
from repro_torch.core.prng import prng_key
from repro_torch.launch import train as tlaunch
from repro_torch.launch.specs import model_decls
from repro_torch.models.base import init_params
from repro_torch.train.train_step import init_train_state, make_loss_fn, make_train_step
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4            # max |dg| <= GRAD_TOL * max |g_ref|, per leaf
BF16_RTOL = 2e-2
BF16_ATOL = 1e-1
BF16_GRAD_DIST = 0.1       # |g - g_ref| / |g_ref| per leaf (Frobenius), bf16
REMAT_TOL = 1e-6
STEP_RTOL = 1e-4

XLSTM_SHALLOW = dict(n_layers=3, block_pattern=("mlstm", "slstm"))
BF16_ARCHS = ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2")


def _configs(arch, dtype="float32"):
    return configs(arch, dtype, **(XLSTM_SHALLOW if arch == "xlstm-350m" else {}))


@functools.lru_cache(maxsize=None)
def j_value_and_grad(jc):
    """The reference's loss and gradient, jitted once per config, no remat."""
    return jax.jit(jax.value_and_grad(j_make_loss_fn(jc, remat=False)))


def t_value_and_grad(tc, model, data, remat=False):
    """The port's loss and its gradients in the reference's layout."""
    model.requires_grad_(True)
    loss = make_loss_fn(tc, remat=remat)(model, data)
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    return loss.detach(), lm_state_to_arrays({"grads": grads}, tc)["grads"]


def _pairs(ref, got, path=()):
    """``(path, reference leaf, port leaf)`` over the reference's tree."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, sorted(ref), sorted(got))
        for k in ref:
            yield from _pairs(ref[k], got[k], path + (k,))
    else:
        yield "/".join(path), ref, got


def _reference_spread(jc, params, jdata, reps=2, seed=7):
    """Per gradient leaf, the most the reference's own float32 gradient
    moves when its weights are nudged by a relative 1e-7 (about one
    float32 ulp), over ``reps`` nudges: its rounding noise on these inputs."""
    rng = np.random.default_rng(seed)
    _, base = j_value_and_grad(jc)(params, jdata)
    spread = None
    for _ in range(reps):
        nudged = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) * (
            1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32)), params)
        _, moved = j_value_and_grad(jc)(nudged, jdata)
        d = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
                         base, moved)
        spread = d if spread is None else jax.tree.map(max, spread, d)
    return spread


def _fan_in_pair(arch, dtype="float32"):
    """(configs, reference params, port model) on port draws with each
    layer's own fan-in (std ``1/sqrt(d_in)``), carried to the reference."""
    jc, tc = _configs(arch, dtype)
    model = init_params(model_decls(tc, fan_in=True), prng_key(0))
    return jc, tc, jax.tree.map(jnp.asarray, ref_params(model, tc)), model


def _hold_fp32_gradients(arch, jc, tc, params, model, noise_bound):
    """The loss within 1e-5 and each gradient leaf within ``noise_bound``
    of the reference's (``max |dg|``, per leaf); returns the leaves'
    ``max |dg| / max |g_ref|``."""
    data = batch(jc, b=2, s=16, seed=3)
    want, jgrads = j_value_and_grad(jc)(params, to_jax(data, jc))
    got, tgrads = t_value_and_grad(tc, model, to_torch(data, tc))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    bounds = noise_bound(data)
    rel = {}
    for name, g_ref, g in _pairs(jax.tree.map(np.asarray, jgrads), tgrads):
        assert tuple(g.shape) == g_ref.shape and g.dtype == torch.float32, name
        scale = float(np.abs(g_ref).max())
        bound = max(GRAD_TOL * scale, bounds.get(name, 0.0))
        err = float(np.abs(f32(g) - g_ref).max())
        assert err <= bound, (name, err, bound)
        rel[name] = err / scale
    assert len(rel) == len(jax.tree.leaves(jgrads))
    return rel


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_gradients_match_reference_fp32_fan_in_weights(arch):
    """Weights of each layer's own fan-in: the loss within 1e-5 and each
    gradient leaf within 1e-4 of its largest entry, the stated fixed
    tolerances.  This is the check that gates the float32 backward."""
    jc, tc, params, model = _fan_in_pair(arch)
    _hold_fp32_gradients(arch, jc, tc, params, model, lambda data: {})


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_gradients_match_reference_fp32(arch):
    """The reference's own draws, beside the fan-in check above: loss
    within 1e-5; each gradient leaf within 1e-4 of its largest entry, or
    within twice the reference's own rounding noise on these weights where
    that is larger (:func:`_reference_spread`).  The reference's init
    (std ``1/sqrt(n_cycles)`` inside a stacked cycle) makes the reduced
    encoder-decoder's float32 gradient ill-conditioned: a 1e-7 nudge moves
    the reference's own decoder value-projection gradient by ~1e-2 of its
    largest entry, and the port lies 2.8e-3 from it.  Elsewhere the port
    lies at most 1.2e-4 from the reference, at its noise (h2o-danube's
    embedding gradient: 1.21e-4 against a spread of 1.24e-4)."""
    jc, tc = _configs(arch)
    params, model = models(jc, tc)

    def spread(data):
        tree = _reference_spread(jc, params, to_jax(data, jc))
        return {name: 2 * noise for name, noise, _ in _pairs(tree, tree)}

    _hold_fp32_gradients(arch, jc, tc, params, model, spread)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_loss_and_gradients_match_reference_bf16(arch):
    """bfloat16 weights of each layer's own fan-in: the loss within rtol
    2e-2, atol 1e-1 of the reference's bf16 loss, and each gradient leaf
    held against the reference's float32 gradient at the same
    (bf16-valued) weights, elementwise within ``2e-2 |g_ref| + 1e-1 max
    |g_ref|`` (the serving tests' bf16 rtol and atol, the atol taken
    relative to the leaf's scale) and within a relative distance of 0.1
    over the leaf (Frobenius).  A zero gradient lies at distance 1 and a
    flipped one at 2.  Measured: the port lies 9.4e-3 to 5.9e-2 from the float32 gradient
    (the MoE's ``shared_mix`` worst), the reference's own bf16 gradient
    9.8e-3 to 2.6e-2 for the dense arch and the encoder-decoder; for the
    MoE on this batch it lies 0.26 away, a token routed otherwise in
    bf16, so it is not the yardstick."""
    jc, tc, params, model = _fan_in_pair(arch, "bfloat16")
    data = batch(jc, b=2, s=16, seed=3)
    want, jgrads = j_value_and_grad(jc)(params, to_jax(data, jc))
    got, tgrads = t_value_and_grad(tc, model, to_torch(data, tc))
    np.testing.assert_allclose(float(got), float(want), rtol=BF16_RTOL, atol=BF16_ATOL)
    for name, ref, g in _pairs(jax.tree.map(np.asarray, jgrads), tgrads):
        assert str(g.dtype) == f"torch.{ref.dtype.name}", name
    jc32 = dataclasses.replace(jc, dtype=jnp.float32)
    _, exact = j_value_and_grad(jc32)(jax.tree.map(lambda a: a.astype(jnp.float32), params),
                                      to_jax(data, jc32))
    for name, x, g in _pairs(jax.tree.map(np.asarray, exact), tgrads):
        g, scale = f32(g), float(np.abs(x).max())
        np.testing.assert_allclose(g, x, rtol=BF16_RTOL, atol=BF16_ATOL * scale, err_msg=name)
        dist = float(np.linalg.norm(g - x) / np.linalg.norm(x))
        assert dist <= BF16_GRAD_DIST, (name, dist)


@pytest.mark.parametrize("arch", ("codeqwen1.5-7b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"))
def test_remat_matches_no_remat(arch):
    """A dense arch (full cycles only), an arch with a tail, the
    encoder-decoder: the same loss and gradients with the cycles and the
    loss chunks recomputed in the backward."""
    _, tc = _configs(arch)
    _, model = models(*_configs(arch))
    data = to_torch(batch(tc, b=2, s=16, seed=4), tc)
    l0, g0 = t_value_and_grad(tc, model, data, remat=False)
    l1, g1 = t_value_and_grad(tc, model, data, remat=True)
    np.testing.assert_allclose(float(l1), float(l0), rtol=REMAT_TOL)
    for name, a, b in _pairs(g0, g1):
        np.testing.assert_allclose(f32(b), f32(a), rtol=REMAT_TOL, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "seamless-m4t-large-v2"))
def test_bf16_loss_takes_its_logits_in_fp32(arch):
    """bfloat16 weights: the loss equals the cross entropy of the float32
    logits of the same bf16 hidden states (rtol 1e-6), so the cast sits
    before the softmax.  Logits left in bf16 move it by ~1e-4 and more."""
    import torch.nn.functional as F

    from repro_torch.models import encdec as ted
    from repro_torch.models import transformer as ttfm

    jc, tc = _configs(arch, "bfloat16")
    _, model = models(jc, tc)
    data = to_torch(batch(tc, b=2, s=16, seed=5), tc)
    embed = model["embed"]
    head = embed["tok"].T if tc.tie_embeddings else embed["head"]
    with torch.no_grad():
        if tc.is_encoder_decoder:
            got = ted.encdec_loss(model, data["frontend_embeds"], data["dec_tokens"], tc)
            toks = data["dec_tokens"]
            hidden = ted.encdec_forward(model, data["frontend_embeds"], toks, tc)
            aux = 0.0
        else:
            got = ttfm.lm_loss(model, data["tokens"], tc, remat=False)
            toks = data["tokens"]
            hidden, aux = ttfm.forward(model, toks, tc)
        assert hidden.dtype == torch.bfloat16
        logits = (hidden[:, :-1] @ head).float()
        want = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               toks[:, 1:].reshape(-1).long()) + 0.01 * aux
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_chunks_follow_the_reference_rule():
    """``loss_chunk`` splits ``S - 1`` when it divides, else one chunk; the
    sum over chunks equals the unchunked loss."""
    from repro_torch.models import transformer as ttfm

    jc, tc = _configs("h2o-danube-1.8b")
    _, model = models(jc, tc)
    toks = torch.from_numpy(batch(tc, b=2, s=17, seed=5)["tokens"])      # S - 1 = 16
    whole = ttfm.lm_loss(model, toks, tc, loss_chunk=16, remat=False)
    for chunk in (4, 8, 5):                                                # 5: no split
        got = ttfm.lm_loss(model, toks, tc, loss_chunk=chunk, remat=True)
        np.testing.assert_allclose(float(got), float(whole), rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _tcfgs(**changes):
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=6, **changes)
    return JTrainConfig(**kw), TrainConfig(**kw)


@pytest.mark.parametrize("changes", [dict(microbatches=1), dict(microbatches=2),
                                     dict(microbatches=2, grad_compression=True)],
                         ids=["mb1", "mb2", "mb2-compressed"])
def test_train_step_matches_reference(changes):
    """Three steps from the same weights on the reference's synthetic
    batches: the losses agree within 1e-4, the metric keys are the same.
    (Parameters after a step are not compared elementwise: Adam's first
    step moves each by ~lr * sign(g), which a gradient within rounding of
    zero may flip.)"""
    jc, tc = _configs("h2o-danube-1.8b")
    jt, tt = _tcfgs(remat="none", **changes)
    params, model = models(jc, tc)
    jstate, tstate = j_init_state(params, jt), init_train_state(model, tt)
    jstep, tstep = jax.jit(j_make_train_step(jc, jt)), make_train_step(tc, tt)
    for step in range(3):
        jb = jlaunch.synthetic_lm_batch(jc, 4, 16, step)
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        assert all(v.dtype == torch.float32 and v.shape == () for v in tm.values())
    assert int(tstate["opt"].step) == 3


@pytest.mark.parametrize("arch,dtype", [("h2o-danube-1.8b", "float32"),
                                        ("h2o-danube-1.8b", "bfloat16"),
                                        ("qwen2-moe-a2.7b", "float32"),
                                        ("seamless-m4t-large-v2", "float32")])
def test_compression_quantizes_the_references_stacked_leaves(arch, dtype):
    """``compress_grads`` on random gradients and residuals, carried to the
    reference's layout, equals the reference's ``compressed_grad_sync`` of
    the stacked trees bit for bit: gradients and residuals.  Reduced
    h2o-danube's ``attn_norm/scale`` is 3 x 64, so one 2,048-element block
    spans its three layers (as do qwen2-moe's ``router`` and
    ``shared_mix``); compressed layer by layer, it would take three
    scales."""
    from repro.distributed.collectives import compressed_grad_sync as j_compress
    from repro_torch.train.train_step import compress_grads

    _, tc = _configs(arch, dtype)
    rng = np.random.default_rng(11)
    model = init_params(model_decls(tc), prng_key(0))
    grads, residual = {}, {}
    for name, p in model.named_parameters():
        scale = 10.0 ** rng.integers(-3, 2, p.shape[:1] + (1,) * (p.dim() - 1))
        g = rng.standard_normal(p.shape) * scale
        grads[name] = torch.from_numpy(g.astype(np.float32)).to(p.dtype)
        residual[name] = torch.from_numpy(
            (1e-3 * rng.standard_normal(p.shape)).astype(np.float32))
    got_g, got_r = compress_grads(tc, grads, residual)
    assert list(got_g) == list(grads) and list(got_r) == list(grads)
    to_ref = lm_state_to_arrays({"g": grads, "r": residual, "dg": got_g, "dr": got_r}, tc)
    want_g, want_r = j_compress(jax.tree.map(lambda t: jnp.asarray(np_leaf(t)), to_ref["g"]),
                                jax.tree.map(lambda t: jnp.asarray(t.numpy()), to_ref["r"]))
    pairs = list(_pairs(jax.tree.map(np.asarray, want_g), to_ref["dg"]))
    assert len(pairs) == len(jax.tree.leaves(want_g))
    for name, want, got in pairs:
        assert np_leaf(got).dtype == want.dtype, name
        np.testing.assert_array_equal(np_leaf(got), want, err_msg=name)
    for name, want, got in _pairs(jax.tree.map(np.asarray, want_r), to_ref["dr"]):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    if arch == "h2o-danube-1.8b":
        assert to_ref["dg"]["layers"]["cyc"]["0"]["attn_norm"]["scale"].shape == (3, 64)


def test_train_step_matches_reference_moe_fan_in_compressed():
    """Reduced qwen2-moe, microbatches 2, compression on, on weights of each
    layer's own fan-in: three steps' losses within 1e-4 of the reference's
    (fault 7: compressed layer by layer, they parted by 1.45e-3 at step 1)."""
    jc, tc, params, model = _fan_in_pair("qwen2-moe-a2.7b")
    jt, tt = _tcfgs(remat="none", microbatches=2, grad_compression=True)
    jstate, tstate = j_init_state(params, jt), init_train_state(model, tt)
    jstep, tstep = jax.jit(j_make_train_step(jc, jt)), make_train_step(tc, tt)
    for step in range(3):
        jb = jlaunch.synthetic_lm_batch(jc, 4, 16, step)
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(tm["residual_norm"]), float(jm["residual_norm"]),
                                   rtol=STEP_RTOL)


def test_microbatches_accumulate_in_fp32(monkeypatch):
    """bf16 weights, two microbatches: the accumulated gradient is the mean
    of the two halves' gradients, each added in float32."""
    from repro_torch.train import train_step as ts

    _, tc = _configs("h2o-danube-1.8b", "bfloat16")
    _, model = models(*_configs("h2o-danube-1.8b", "bfloat16"))
    data = to_torch(batch(tc, b=4, s=16, seed=6), tc)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in data.items()} for i in range(2)]
    parts = [t_value_and_grad(tc, model, h)[1] for h in halves]
    captured = {}
    real = ts.adamw_update

    def spy(params, grads, opt, tcfg):
        captured.update(grads)
        return real(params, grads, opt, tcfg)

    monkeypatch.setattr(ts, "adamw_update", spy)
    make_train_step(tc, TrainConfig(microbatches=2, remat="none"))(
        init_train_state(model, TrainConfig()), data)
    got = lm_state_to_arrays({"g": captured}, tc)["g"]
    for (name, a, g), (_, b, _) in zip(_pairs(parts[0], got), _pairs(parts[1], got)):
        assert g.dtype == torch.float32, name
        want = (a.float() + b.float()) / 2
        np.testing.assert_array_equal(f32(g), f32(want), err_msg=name)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "qwen2-vl-7b", "seamless-m4t-large-v2"))
def test_synthetic_lm_batch_equals_reference(arch):
    jc, tc = configs(arch, "bfloat16")
    for step in (0, 7):
        want = jlaunch.synthetic_lm_batch(jc, 3, 40, step)
        got = tlaunch.synthetic_lm_batch(tc, 3, 40, step, device="cpu")
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            g = got[k]
            assert tuple(g.shape) == w.shape, k
            if w.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              w.view(np.int16), err_msg=k)
            else:
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def _reduced_danube(**changes):
    return dataclasses.replace(configs("h2o-danube-1.8b", "float32")[1], **changes)


def test_run_training_on_cpu_returns_the_reference_keys(capsys):
    cfg = _reduced_danube()
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4, microbatches=2)
    out = tlaunch.run_training(cfg, tcfg, device="cpu", batch=4, seq=32, steps=4, log_every=1)
    assert set(out) == {"loss", "grad_norm", "lr", "first_loss"}
    assert all(np.isfinite(v) for v in out.values())
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 4


def test_run_training_resumes_to_the_uninterrupted_state(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, and a resumed run
    to 4: the same final state exactly, and the same last loss."""
    cfg = _reduced_danube()
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4, checkpoint_every=2)
    whole = tlaunch.run_training(cfg, tcfg, device="cpu", batch=2, seq=32, steps=4,
                                 ckpt_dir=str(tmp_path / "a"))
    tlaunch.run_training(cfg, tcfg, device="cpu", batch=2, seq=32, steps=2,
                         ckpt_dir=str(tmp_path / "b"))
    resumed = tlaunch.run_training(cfg, tcfg, device="cpu", batch=2, seq=32, steps=4,
                                   ckpt_dir=str(tmp_path / "b"))
    assert resumed["loss"] == whole["loss"]
    template = tlaunch.state_template(cfg, tcfg)
    assert all(t.is_meta for _, t in _flat(template))
    a, step_a, _ = restore_pytree(template, str(tmp_path / "a"))
    b, step_b, _ = restore_pytree(template, str(tmp_path / "b"))
    assert step_a == step_b == 4
    for (name, x), (_, y) in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y), name


def test_state_export_is_a_fresh_host_copy():
    """``lm_state_to_arrays`` hands out host tensors that nothing else holds
    (the optimizer writes the live state in place after a checkpoint's
    export), and a state on the meta device exports meta tensors."""
    cfg = _reduced_danube()
    tcfg = TrainConfig(grad_compression=True)
    state = init_train_state(init_params(model_decls(cfg), prng_key(0)),
                             tcfg)
    tree = lm_state_to_arrays(state, cfg)
    before = [(n, t.clone()) for n, t in _flat(tree)]
    with torch.no_grad():
        for p in state["params"].parameters():
            p.add_(1)
        for part in (state["opt"].m, state["opt"].v, state["opt"].master, state["residual"]):
            for t in part.values():
                t.add_(1)
        state["opt"].step.add_(1)
    for (name, t), (_, b) in zip(_flat(tree), before):
        assert t.device.type == "cpu" and torch.equal(t, b), name
    template = tlaunch.state_template(cfg, tcfg)
    assert [(n, t.shape, t.dtype) for n, t in _flat(template)] == [
        (n, t.shape, t.dtype) for n, t in _flat(tree)]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _flat(getattr(tree, f.name), f"{path}/.{f.name}")
    else:
        yield path, tree


_LOG = re.compile(r"^step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} lr \d\.\d{2}e[-+]\d\d \d+\.\d\ds$")


def test_launcher_prints_the_reference_lines_and_resumes(tmp_path, capsys):
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "4", "--batch", "4",
            "--seq", "32", "--device", "cpu"]
    tlaunch.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=h2o-danube-1.8b params=") and "device=cpu" in out[0]
    steps = [ln for ln in out if ln.startswith("step")]
    assert len(steps) == 2 and all(_LOG.match(ln) for ln in steps), steps   # steps 0 and 3
    tlaunch.main(argv + ["--ckpt-dir", str(tmp_path), "--steps", "2"])
    out = capsys.readouterr().out.splitlines()
    saves = [ln.split(":")[0] for ln in out if ": host copy" in ln]
    assert saves == ["checkpoint step 1", "checkpoint step 2"], out    # each step once
    tlaunch.main(argv + ["--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert "resumed from step 2" in out
    assert [ln.split(":")[0] for ln in out if ": host copy" in ln] == [
        "checkpoint step 4"], out


def test_launcher_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.run_training(_reduced_danube(), TrainConfig(), batch=2, seq=16, steps=1)


# ---------------------------------------------------------------------------
# A train state between the two packages' checkpoints
# ---------------------------------------------------------------------------

def _two_steps_in_the_reference(tmp_path):
    """The reduced h2o-danube in bf16 after 2 reference steps, saved by the
    reference's Checkpointer; returns the configs and the step function."""
    jc, tc = configs("h2o-danube-1.8b", "bfloat16")
    jt, tt = _tcfgs(remat="none")
    params, _ = models(jc, tc)
    jstate = j_init_state(params, jt)
    jstep = jax.jit(j_make_train_step(jc, jt))
    for step in range(2):
        jstate, _ = jstep(jstate, jlaunch.synthetic_lm_batch(jc, 2, 16, step))
    ck = JCheckpointer(str(tmp_path))
    ck.save(jstate, 2)
    ck.wait()
    return jc, tc, jt, tt, jstate, jstep


def _next_loss_fp32(jc, tc, jt, tt, jstate, tstate):
    """One more step from the same state on both sides, in float32 (the
    bf16 weights widened exactly): the losses."""
    jc32 = dataclasses.replace(jc, dtype=jnp.float32)
    tc32 = dataclasses.replace(tc, dtype=torch.float32)
    jstate32 = {"params": jax.tree.map(lambda a: a.astype(jnp.float32), jstate["params"]),
                "opt": jstate["opt"]}
    tree = lm_state_to_arrays(tstate, tc)
    tstate32 = lm_state_from_arrays(tc32, tree, device="cpu")
    jb = jlaunch.synthetic_lm_batch(jc32, 2, 16, 2)
    _, jm = jax.jit(j_make_train_step(jc32, jt))(jstate32, jb)
    _, tm = make_train_step(tc32, tt)(tstate32, {k: torch.from_numpy(np.array(v))
                                                 for k, v in jb.items()})
    return float(jm["loss"]), float(tm["loss"])


def test_reference_train_state_resumes_in_the_port(tmp_path):
    jc, tc, jt, tt, jstate, _ = _two_steps_in_the_reference(tmp_path)
    tree, step, _ = Checkpointer(str(tmp_path)).restore(tlaunch.state_template(tc, tt))
    assert step == 2
    tstate = lm_state_from_arrays(tc, tree, device="cpu")
    assert int(tstate["opt"].step) == 2
    back = lm_state_to_arrays(tstate, tc)
    ref = jax.tree.map(np.asarray, jstate)
    pairs = list(_pairs(ref["params"], back["params"]))
    pairs += [(f".{f}/{n}", r, g) for f in ("m", "v", "master")
              for n, r, g in _pairs(getattr(ref["opt"], f), getattr(back["opt"], f))]
    for name, r, g in pairs:
        if r.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), r.view(np.int16),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    want, got = _next_loss_fp32(jc, tc, jt, tt, jstate, tstate)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)


def test_port_train_state_resumes_in_the_reference(tmp_path):
    """The port trains 2 steps in bf16 from the reference's weights and
    saves; the reference restores that state bit for bit and its next step
    gives the port's next loss."""
    jc, tc = configs("h2o-danube-1.8b", "bfloat16")
    jt, tt = _tcfgs(remat="none")
    params, model = models(jc, tc)
    tstate = init_train_state(model, tt)
    tstep = make_train_step(tc, tt)
    for step in range(2):
        tstate, _ = tstep(tstate, tlaunch.synthetic_lm_batch(tc, 2, 16, step, device="cpu"))
    ck = Checkpointer(str(tmp_path))
    ck.save(lm_state_to_arrays(tstate, tc), 2)
    ck.wait()
    restored, step, _ = j_restore(j_init_state(params, jt), str(tmp_path))
    assert step == 2 and int(restored["opt"].step) == 2
    back = lm_state_to_arrays(tstate, tc)
    for name, r, g in _pairs(jax.tree.map(np.asarray, restored["params"]), back["params"]):
        assert r.dtype.name == {torch.bfloat16: "bfloat16", torch.float32: "float32"}[g.dtype]
        np.testing.assert_array_equal(r.view(np.uint8), f32(g.view(torch.int16)).astype(
            np.int16).view(np.uint8) if g.dtype == torch.bfloat16 else g.numpy().view(np.uint8),
            err_msg=name)
    want, got = _next_loss_fp32(jc, tc, jt, tt, restored, tstate)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
