"""The LM steps over a mesh against the unmeshed port, on the CPU.

Meshes are ``cpu`` repeated (``make_test_mesh``).  A meshed step is the
same function of the global batch as the unmeshed one (the unmeshed port
is held to the reference by ``test_torch_lm_train.py``), run over its data
shards with the state in blocks.  For an arch whose rows do not interact,
a data-2 mesh at microbatches ``k`` is held against the unmeshed step at
``2 k``, which adds the same per-shard sums in the same order; an MoE
arch's routing groups and balance loss are functions of the whole
microbatch, so it is held against the unmeshed step at ``k``.  Losses
within 1e-6, ``grad_norm`` within 1e-5 (relative), the gradients leaf by
leaf within 1e-5 of the leaf's largest entry (gradients, not parameters
after a step: Adam's first update is about ``lr * sign(g)``, which a
gradient within rounding of zero may flip).

These mirror the reference's multi-device tests
(``tests/test_multidevice.py``: reduced h2o-danube on 2 x 4 over 4 steps,
a ``serve_tp`` decode of reduced recurrentgemma, compression in the real
step), which need eight XLA devices in a subprocess.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config, list_archs, reduced_config
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import DeviceMesh, make_test_mesh
from repro_torch.launch.serve import generate
from repro_torch.launch.specs import model_decls, param_shardings
from repro_torch.launch.train import synthetic_lm_batch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.blocks import BlockStore, batch_shards, shard_params
from repro_torch.train.serve_step import decode, prefill
from repro_torch.train.train_step import (
    gather_train_state,
    init_train_state,
    loss_and_grads,
    make_train_step,
    shard_train_state,
)

ARCHS = list_archs()
LOSS_RTOL = 1e-6
GNORM_RTOL = 1e-5
GRAD_TOL = 1e-5


@pytest.fixture
def profile():
    def use(name):
        tpart.set_profile(name)

    try:
        yield use
    finally:
        tpart.set_profile("tp")


def _cfg(arch, **changes):
    return dataclasses.replace(reduced_config(get_config(arch)), dtype=torch.float32, **changes)


def _model(cfg, seed=0):
    """Weights of each layer's own fan-in (well conditioned in float32)."""
    return init_params(model_decls(cfg, fan_in=True), torch.Generator().manual_seed(seed))


def _tcfg(**changes):
    return TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6, remat="full",
                       **changes)


def _matching(cfg, k, dp):
    """The unmeshed microbatch count a data-``dp`` mesh at ``k`` is held to."""
    return k if cfg.is_moe else k * dp


def _hold_grads(got, want):
    assert list(got) == list(want)
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_TOL * max(scale, 1e-30), name


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _hold_steps(cfg, tcfg_mesh, tcfg_flat, mesh, steps=3, batch=4, seq=16):
    model = _model(cfg)
    flat = init_train_state(copy.deepcopy(model), tcfg_flat)
    meshed = init_train_state(shard_params(model, cfg, mesh), tcfg_mesh)
    f_step, m_step = make_train_step(cfg, tcfg_flat), make_train_step(cfg, tcfg_mesh, mesh)
    for step in range(steps):
        b = synthetic_lm_batch(cfg, batch, seq, step, "cpu")
        if step == 0:
            lw, gw = loss_and_grads(cfg, tcfg_flat, flat["params"], b)
            lg, gg = loss_and_grads(cfg, tcfg_mesh, meshed["params"], b, mesh=mesh)
            assert _rel(lg, lw) <= LOSS_RTOL
            _hold_grads(gg, gw)
        flat, fm = f_step(flat, b)
        meshed, mm = m_step(meshed, b)
        assert set(mm) == set(fm)
        assert all(v.dtype == torch.float32 and v.shape == () for v in mm.values())
        assert _rel(mm["loss"], fm["loss"]) <= LOSS_RTOL, (step, float(mm["loss"]))
        assert _rel(mm["grad_norm"], fm["grad_norm"]) <= GNORM_RTOL, step
        assert float(mm["lr"]) == float(fm["lr"])
        if "residual_norm" in fm:
            assert _rel(mm["residual_norm"], fm["residual_norm"]) <= GNORM_RTOL, step
    assert int(meshed["opt"].step) == steps
    return flat, meshed


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prof,shape", [("tp", (2, 4)), ("dp", (2, 2))], ids=["tp-2x4", "dp-2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_train_step_equals_unmeshed(arch, prof, shape, profile):
    profile(prof)
    cfg = _cfg(arch)
    mesh = make_test_mesh(*shape, device="cpu")
    _hold_steps(cfg, _tcfg(microbatches=1), _tcfg(microbatches=_matching(cfg, 1, shape[0])),
                mesh)


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2"))
def test_meshed_compressed_step_equals_unmeshed(arch, profile):
    """Compression runs on the reduced gradient in the reference's stacked
    layout; the residual stays in blocks.  Where the meshed step adds the
    unmeshed step's sums (no MoE), the residual gathers to the unmeshed one
    bit for bit; an MoE arch's gradient differs by rounding, which may move
    an element across an int8 rounding boundary, so it is held by the
    residual's norm."""
    profile("tp")
    cfg = _cfg(arch)
    mesh = make_test_mesh(2, 2, device="cpu")
    flat, meshed = _hold_steps(cfg, _tcfg(microbatches=1, grad_compression=True),
                               _tcfg(microbatches=_matching(cfg, 1, 2), grad_compression=True),
                               mesh)
    whole = gather_train_state(meshed)
    assert list(whole["residual"]) == list(flat["residual"])
    if not cfg.is_moe:
        for name, r in flat["residual"].items():
            assert torch.equal(whole["residual"][name], r), name


def test_reduced_h2o_danube_on_2x4_two_microbatches_four_steps(profile):
    """The reference's ``test_sharded_train_step_runs``: 2 x 4, microbatches
    2, four steps, the loss falling."""
    profile("tp")
    cfg = _cfg("h2o-danube-1.8b")
    mesh = make_test_mesh(2, 4, device="cpu")
    _, meshed = _hold_steps(cfg, _tcfg(microbatches=2), _tcfg(microbatches=4), mesh, steps=4,
                            batch=8)
    assert all(isinstance(meshed[k], BlockStore) for k in ("params",))


def test_a_batch_that_does_not_divide_is_counted_once(profile):
    """A batch of 1 on a data-2 mesh: ``sharding_for`` drops the batch axis,
    one shard holds the whole batch, and the gradient is the unmeshed
    microbatch-1 gradient, in the parameters' dtype (counted once, not
    twice)."""
    profile("tp")
    cfg = _cfg("h2o-danube-1.8b")
    mesh = make_test_mesh(2, 2, device="cpu")
    assert [s.pos for s in batch_shards(mesh, 1)] == [(0, 0)]
    assert [s.pos for s in batch_shards(mesh, 4)] == [(0, 0), (1, 0)]
    _hold_steps(cfg, _tcfg(microbatches=1), _tcfg(microbatches=1), mesh, batch=1)
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = init_params(model_decls(bf, fan_in=True), torch.Generator().manual_seed(0))
    b = synthetic_lm_batch(bf, 1, 16, 0, "cpu")
    lw, gw = loss_and_grads(bf, _tcfg(), copy.deepcopy(model), b)
    lg, gg = loss_and_grads(bf, _tcfg(), model, b, mesh=mesh)
    assert float(lg) == float(lw)
    for name, g in gg.items():
        assert g.dtype == gw[name].dtype
        torch.testing.assert_close(g, gw[name], rtol=0, atol=0)


def test_moe_routing_groups_and_balance_loss_are_the_whole_batchs(profile):
    """Reduced qwen2-moe at 2 x 16 on a data-2 mesh: 16 tokens a shard, under
    the 64-token routing group, so the group of 32 spans both shards.  The
    meshed forward keeps the unmeshed groups and the balance loss of the
    whole batch; routing each shard alone would not."""
    profile("tp")
    cfg = _cfg("qwen2-moe-a2.7b")
    assert cfg.router_group_size > 16
    mesh = make_test_mesh(2, 2, device="cpu")
    model = _model(cfg)
    toks = synthetic_lm_batch(cfg, 2, 16, 0, "cpu")["tokens"]
    with torch.no_grad():
        h0, a0 = tfm.forward(model, toks, cfg, remat=False)
        h1, a1 = tfm.forward(model, toks, cfg, mesh=mesh, remat=False)
        alone = sum(float(tfm.forward(model, toks[i:i + 1], cfg, remat=False)[1])
                    for i in range(2)) / 2
    torch.testing.assert_close(h1, h0, rtol=1e-6, atol=1e-6)
    assert _rel(a1, a0) <= 1e-6
    assert abs(alone - float(a0)) > 1e-4          # per-shard routing is another function
    _hold_steps(cfg, _tcfg(microbatches=1), _tcfg(microbatches=1), mesh, batch=2)


def test_moe_apply_shards_equals_moe_apply_on_uneven_groups():
    """Shards whose sizes neither hold whole groups nor divide them: 3 rows
    of 8 and 5 rows of 8 tokens with groups of 16."""
    cfg = _cfg("qwen2-moe-a2.7b", router_group_size=16)
    p = _model(cfg)["layers"][0]["moe"]
    x = torch.randn(8, 8, cfg.d_model, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y0, a0 = tmoe.moe_apply(p, x, cfg)
        ys, a1 = tmoe.moe_apply_shards([p, p], [x[:3], x[3:]], cfg)
    torch.testing.assert_close(torch.cat(ys), y0, rtol=1e-6, atol=1e-6)
    assert _rel(a1, a0) <= 1e-6


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_prefill_and_decode_equal_unmeshed(arch, profile):
    """``serve_tp`` on 2 x 4: prefill logits, then 4 decode steps' logits
    and greedy tokens."""
    profile("serve_tp")
    cfg = _cfg(arch)
    mesh = make_test_mesh(2, 4, device="cpu")
    model = init_params(model_decls(cfg), torch.Generator().manual_seed(1))
    store = shard_params(model, cfg, mesh)
    rng = np.random.default_rng(2)
    batch = {}
    if cfg.is_encoder_decoder or cfg.modality == "vision":
        batch["frontend_embeds"] = torch.from_numpy(
            rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32))
    key = "dec_tokens" if cfg.is_encoder_decoder else "tokens"
    batch[key] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))
    torch.testing.assert_close(prefill(store, batch, cfg, mesh=mesh), prefill(model, batch, cfg),
                               rtol=1e-6, atol=1e-6)
    prompts = batch[key][:, :4]
    fe = batch.get("frontend_embeds") if cfg.is_encoder_decoder else None
    with torch.no_grad():
        want = generate(cfg, model, prompts, 4, frontend_embeds=fe)
        got = generate(cfg, store, prompts, 4, frontend_embeds=fe, mesh=mesh)
    assert torch.equal(got, want)


def test_serve_tp_decode_of_recurrentgemma_steps_equal_unmeshed(profile):
    """The reference's ``test_serve_tp_decode_runs``: reduced recurrentgemma
    (RG-LRU and local attention), ``serve_tp`` on 2 x 4, 8 decode steps,
    logits of each step equal to the unmeshed decode's, both caches alike."""
    profile("serve_tp")
    cfg = _cfg("recurrentgemma-2b")
    mesh = make_test_mesh(2, 4, device="cpu")
    model = init_params(model_decls(cfg), torch.Generator().manual_seed(4))
    store = shard_params(model, cfg, mesh)
    assert {s.spec for s in param_shardings(cfg, mesh).values()} >= {(None, "model")}
    c0 = tfm.init_decode_cache(4, cfg, 8, "cpu")
    c1 = tfm.init_decode_cache(4, cfg, 8, "cpu")
    tok = torch.arange(4, dtype=torch.int32)[:, None]
    with torch.no_grad():
        for i in range(8):
            l0, c0 = decode(model, tok, c0, i, cfg)
            l1, c1 = decode(store, tok, c1, i, cfg, mesh=mesh)
            torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
            for a, b in zip(c0, c1):
                for k in a:
                    torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=1e-6)
            tok = l0.argmax(-1).to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Storage, state and the launcher
# ---------------------------------------------------------------------------

def test_blocks_hold_each_positions_shard_and_gather_back(profile):
    """Every position holds the block its coordinates name (the shard shape
    of the leaf's sharding, so each position holds the same bytes), and
    gathering returns the leaf; a dim sharded over two axes splits with the
    first axis major."""
    profile("dp")
    cfg = _cfg("h2o-danube-1.8b")
    mesh = make_test_mesh(2, 2, device="cpu")
    model = _model(cfg)
    store = shard_params(model, cfg, mesh)
    shardings = param_shardings(cfg, mesh)
    for name, p in model.named_parameters():
        sh = shardings[name]
        for pos, blk in store.blocks[name].items():
            assert tuple(blk.shape) == sh.shard_shape(tuple(p.shape))
        assert torch.equal(store.full(name), p.detach())
    wq = "layers.0.attn.wq"
    assert shardings[wq].spec == (("data", "model"), None)
    rows = model.layers[0].attn.wq.shape[0] // 4
    for pos, i in (((0, 0), 0), ((0, 1), 1), ((1, 0), 2), ((1, 1), 3)):
        assert torch.equal(store.blocks[wq][pos], model.layers[0].attn.wq[i * rows:(i + 1) * rows])
    per_position = sum(int(np.prod(shardings[n].shard_shape(tuple(p.shape)))) * p.element_size()
                       for n, p in model.named_parameters())
    assert [store.nbytes_at(pos) for pos in store.positions] == [per_position] * 4


def test_train_state_lays_out_and_gathers_back(profile):
    profile("tp")
    cfg = _cfg("qwen2-moe-a2.7b")
    mesh = DeviceMesh([["cpu"] * 2] * 2)
    tcfg = _tcfg(grad_compression=True)
    flat = init_train_state(_model(cfg), tcfg)
    meshed = shard_train_state(flat, cfg, mesh)
    for part in ("m", "v", "master"):
        assert all(b.dtype == torch.float32 for bl in getattr(meshed["opt"], part).blocks.values()
                   for b in bl.values())
    back = gather_train_state(meshed)
    for name, p in flat["params"].named_parameters():
        assert torch.equal(back["params"][name], p.detach())
        assert torch.equal(back["opt"].master[name], flat["opt"].master[name])
        assert torch.equal(back["residual"][name], flat["residual"][name])
    fresh = init_train_state(shard_params(flat["params"], cfg, mesh), tcfg)
    assert set(fresh) == {"params", "opt", "residual"}
    assert torch.equal(gather_train_state(fresh)["opt"].master["embed.tok"],
                       flat["opt"].master["embed.tok"])


def test_run_training_on_a_mesh_equals_the_unmeshed_run_and_resumes(tmp_path, profile, capsys):
    """``run_training(cfg, tcfg, mesh)``: the same losses as the unmeshed run
    at twice the microbatches; its checkpoint (gathered, in the reference's
    layout) resumes to the uninterrupted run."""
    profile("tp")
    cfg = _cfg("h2o-danube-1.8b")
    mesh = make_test_mesh(2, 2, device="cpu")
    tcfg = _tcfg(checkpoint_every=2)
    kw = dict(batch=4, seq=16, log_every=1)
    flat = tlaunch.run_training(cfg, dataclasses.replace(tcfg, microbatches=2), device="cpu",
                                steps=4, **kw)
    meshed = tlaunch.run_training(cfg, tcfg, mesh, steps=4, **kw)
    assert _rel(meshed["loss"], flat["loss"]) <= LOSS_RTOL
    assert _rel(meshed["first_loss"], flat["first_loss"]) <= LOSS_RTOL
    tlaunch.run_training(cfg, tcfg, mesh, steps=2, ckpt_dir=str(tmp_path), **kw)
    resumed = tlaunch.run_training(cfg, tcfg, mesh, steps=4, ckpt_dir=str(tmp_path), **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert _rel(resumed["loss"], meshed["loss"]) <= LOSS_RTOL
