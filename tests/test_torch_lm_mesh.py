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

Under ``tp`` and ``serve_tp`` the split layers sum partial products over
``model`` (``distributed/collectives.py``), another float order than the
unmeshed products, so the split function is the unmeshed one up to
rounding.  Each check holds its tolerance; where rounding grows past it
(xLSTM's 17 layers, served logits at 1e-6, bf16), the check holds the
split within the witness: twice the most the unmeshed function itself
moves when every weight moves one ulp, up or down at random (``nudged``,
three draws).  Beside each such case a float64 case (xLSTM: its 3-layer
stack, whose state math is float32 in any dtype) holds the tolerance
alone.

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
from repro_torch.core.prng import prng_key
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
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

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


#: xLSTM's reduced stack cut to 3 layers, where rounding does not grow
#: past the tolerances (``test_torch_lm_train.py`` holds it so).
XLSTM_SHALLOW = dict(n_layers=3, block_pattern=("mlstm", "slstm"))
#: The one-ulp draws of the witness, and the multiple of their largest
#: shift that the split is held to: a largest shift of three draws
#: understates a spread with a long tail (seamless's step-2 residual norm
#: under twelve draws: 1.3e-7 to 1.9e-5, the first three's largest 1.4e-5).
NUDGES, WITNESS_K = 3, 2.0


def _cfg(arch, **changes):
    return dataclasses.replace(reduced_config(get_config(arch)),
                               **{"dtype": torch.float32, **changes})


def _shallow_cfg(arch, **changes):
    """``_cfg``, xLSTM on its 3-layer stack."""
    return _cfg(arch, **{**(XLSTM_SHALLOW if arch == "xlstm-350m" else {}), **changes})


def nudged(model, seed):
    """A copy of ``model`` with every floating leaf moved one ulp, up or down
    at random (from ``seed``)."""
    out = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            up = torch.randint(0, 2, p.shape, generator=gen).bool()
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf).to(p.dtype)))
    return out


class Witness:
    """Errors held at a tolerance, or, past it under a profile that splits
    over ``model``, at the witness: ``WITNESS_K`` times the largest error of
    the unmeshed function on ``nudged`` weights against itself (``errors(seed)`` gives
    them, keyed as the held errors; drawn once, when a tolerance is first
    passed).  Under ``dp`` nothing is split: the tolerance alone."""

    def __init__(self, errors, strict=False):
        self.errors, self.draws = errors, None
        self.split = not strict and tpart.get_profile() != "dp"

    def hold(self, key, err, tol):
        if err <= tol:
            return
        assert self.split, (key, err, tol)
        if self.draws is None:
            self.draws = [self.errors(s) for s in range(NUDGES)]
        drawn = max(d[key] for d in self.draws)
        assert err <= WITNESS_K * drawn, (key, err, tol, drawn)


def _model(cfg, seed=0):
    """Weights of each layer's own fan-in (well conditioned in float32)."""
    return init_params(model_decls(cfg, fan_in=True), prng_key(seed))


def _tcfg(**changes):
    return TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6, remat="full",
                       **changes)


def _matching(cfg, k, dp):
    """The unmeshed microbatch count a data-``dp`` mesh at ``k`` is held to."""
    return k if cfg.is_moe else k * dp


def _grad_errs(got, want):
    """Each leaf's largest difference over the leaf's largest entry."""
    assert list(got) == list(want)
    out = {}
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        out[name] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def _hold_grads(got, want):
    for name, err in _grad_errs(got, want).items():
        assert err <= GRAD_TOL, name


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _flat_run(cfg, tcfg, model, batches):
    """The unmeshed step-0 (loss, grads), each step's metrics, the state."""
    state = init_train_state(copy.deepcopy(model), tcfg)
    first = loss_and_grads(cfg, tcfg, state["params"], batches[0])
    step, ms = make_train_step(cfg, tcfg), []
    for b in batches:
        state, m = step(state, b)
        ms.append(m)
    return first, ms, state


def _step_errs(got, want):
    """(the step-0 loss, each leaf, then each step's metrics) -> relative error."""
    (lg, gg), mg, _ = got
    (lw, gw), mw, _ = want
    out = {"loss0": _rel(lg, lw), **_grad_errs(gg, gw)}
    for i, (a, b) in enumerate(zip(mg, mw)):
        out.update({(k, i): _rel(a[k], b[k]) for k in ("loss", "grad_norm", "residual_norm")
                    if k in b})
    return out


def _hold_steps(cfg, tcfg_mesh, tcfg_flat, mesh, steps=3, batch=4, seq=16, strict=False):
    model = _model(cfg)
    batches = [synthetic_lm_batch(cfg, batch, seq, step, "cpu") for step in range(steps)]
    flat = _flat_run(cfg, tcfg_flat, model, batches)
    meshed = init_train_state(shard_params(model, cfg, mesh), tcfg_mesh)
    first = loss_and_grads(cfg, tcfg_mesh, meshed["params"], batches[0], mesh=mesh)
    m_step, ms = make_train_step(cfg, tcfg_mesh, mesh), []
    for b in batches:
        meshed, mm = m_step(meshed, b)
        ms.append(mm)
    for mm, fm in zip(ms, flat[1]):
        assert set(mm) == set(fm)
        assert all(v.dtype == fm[k].dtype and v.shape == () for k, v in mm.items())
        if cfg.dtype != torch.float64:      # a float64 model's loss is float64
            assert all(v.dtype == torch.float32 for v in mm.values())
        assert float(mm["lr"]) == float(fm["lr"])
    witness = Witness(lambda s: _step_errs(_flat_run(cfg, tcfg_flat, nudged(model, s), batches),
                                           flat), strict)
    tols = {"loss0": LOSS_RTOL, "loss": LOSS_RTOL, "grad_norm": GNORM_RTOL,
            "residual_norm": GNORM_RTOL}
    for key, err in _step_errs((first, ms, None), flat).items():
        witness.hold(key, err, tols.get(key[0] if isinstance(key, tuple) else key, GRAD_TOL))
    assert int(meshed["opt"].step) == steps
    return flat[2], meshed


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


def test_meshed_train_step_of_xlstms_3_layer_stack_holds_the_tolerances(profile):
    """xLSTM under ``tp`` on 2 x 4 on its 3-layer stack, at the tolerances
    alone (its 17 layers grow rounding past them)."""
    profile("tp")
    _hold_steps(_shallow_cfg("xlstm-350m"), _tcfg(microbatches=1), _tcfg(microbatches=2),
                make_test_mesh(2, 4, device="cpu"), strict=True)


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2"))
def test_meshed_compressed_step_equals_unmeshed(arch, profile):
    """Compression runs on the reduced gradient in the reference's stacked
    layout; the residual stays in blocks.  Under ``tp`` the row-parallel
    products sum over ``model`` in another order than the unmeshed products
    (and an MoE arch's gradient differs by rounding in any case), which may
    move an element across an int8 rounding boundary, so the residual is
    held by its norm (``_hold_steps``)."""
    _hold_compressed(arch, "tp", profile)


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "seamless-m4t-large-v2"))
def test_meshed_compressed_step_in_float64_holds_the_residual_norm(arch, profile):
    """The same under ``tp`` in float64, at the tolerances alone."""
    _hold_compressed(arch, "tp", profile, torch.float64, strict=True)


def _hold_compressed(arch, prof, profile, dtype=torch.float32, strict=False):
    profile(prof)
    cfg = _cfg(arch, dtype=dtype)
    mesh = make_test_mesh(2, 2, device="cpu")
    flat, meshed = _hold_steps(cfg, _tcfg(microbatches=1, grad_compression=True),
                               _tcfg(microbatches=_matching(cfg, 1, 2), grad_compression=True),
                               mesh, strict=strict)
    whole = gather_train_state(meshed)
    assert list(whole["residual"]) == list(flat["residual"])
    return flat["residual"], whole["residual"]


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "seamless-m4t-large-v2"))
def test_meshed_compressed_step_under_dp_keeps_the_residual_bit_for_bit(arch, profile):
    """Under ``dp`` the meshed step adds the unmeshed step's sums: the
    residual gathers to the unmeshed one bit for bit."""
    want, got = _hold_compressed(arch, "dp", profile)
    for name, r in want.items():
        assert torch.equal(got[name], r), name


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
    _hold_bf16_batch_of_one(cfg, mesh)


def test_a_batch_that_does_not_divide_under_dp_is_bit_for_bit_in_bf16(profile):
    """The same batch of 1 in bfloat16 under ``dp``, where nothing is split
    over ``model``: the unmeshed loss and gradient bit for bit."""
    profile("dp")
    _hold_bf16_batch_of_one(_cfg("h2o-danube-1.8b"), make_test_mesh(2, 2, device="cpu"))


def _hold_bf16_batch_of_one(cfg, mesh):
    """bfloat16, batch 1: the unmeshed loss and gradient in the parameters'
    dtype, bit for bit (under a split profile: or within the witness)."""
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = init_params(model_decls(bf, fan_in=True), prng_key(0))
    b = synthetic_lm_batch(bf, 1, 16, 0, "cpu")

    def errs(got, want):
        (lg, gg), (lw, gw) = got, want
        return {"loss": _rel(lg, lw), **_grad_errs(gg, gw)}

    want = loss_and_grads(bf, _tcfg(), copy.deepcopy(model), b)
    got = loss_and_grads(bf, _tcfg(), model, b, mesh=mesh)
    assert all(g.dtype == want[1][n].dtype for n, g in got[1].items())
    witness = Witness(lambda s: errs(loss_and_grads(bf, _tcfg(), nudged(model, s), b), want))
    for key, err in errs(got, want).items():
        witness.hold(key, err, 0.0)


def test_moe_routing_groups_and_balance_loss_are_the_whole_batchs(profile):
    """Reduced qwen2-moe at 2 x 16 on a data-2 mesh: 16 tokens a shard, under
    the 64-token routing group, so the group of 32 spans both shards.  The
    meshed forward keeps the unmeshed groups and the balance loss of the
    whole batch; routing each shard alone would not."""
    profile("tp")
    cfg = _cfg("qwen2-moe-a2.7b")
    _hold_moe_routing(cfg)
    _hold_steps(cfg, _tcfg(microbatches=1), _tcfg(microbatches=1),
                make_test_mesh(2, 2, device="cpu"), batch=2)


def test_moe_routing_of_the_whole_batch_in_float64_holds_the_tolerances(profile):
    """The same forward in float64, at the tolerances alone."""
    profile("tp")
    _hold_moe_routing(_cfg("qwen2-moe-a2.7b", dtype=torch.float64), strict=True)


def _close_err(got, want):
    """``assert_close``'s measure at rtol = atol: max |got - want| / (1 + |want|)."""
    return float(((got - want).abs() / (1 + want.abs())).max())


def _hold_moe_routing(cfg, strict=False):
    assert cfg.router_group_size > 16
    mesh = make_test_mesh(2, 2, device="cpu")
    model = _model(cfg)
    toks = synthetic_lm_batch(cfg, 2, 16, 0, "cpu")["tokens"]

    def errs(got, want):
        return {"h": _close_err(got[0], want[0]), "aux": _rel(got[1], want[1])}

    with torch.no_grad():
        want = tfm.forward(model, toks, cfg, remat=False)
        got = tfm.forward(model, toks, cfg, mesh=mesh, remat=False)
        alone = sum(float(tfm.forward(model, toks[i:i + 1], cfg, remat=False)[1])
                    for i in range(2)) / 2
        witness = Witness(lambda s: errs(tfm.forward(nudged(model, s), toks, cfg, remat=False),
                                         want), strict)
        for key, err in errs(got, want).items():
            witness.hold(key, err, 1e-6)
    assert abs(alone - float(want[1])) > 1e-4     # per-shard routing is another function


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
    and greedy tokens (equal, or parting where the unmeshed logits' top two
    lie within the witness's shift of each other)."""
    _hold_served(_cfg(arch), profile)


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_prefill_and_decode_in_float64_hold_the_tolerances(arch, profile):
    """The same in float64 (xLSTM on its 3-layer stack), at the tolerances
    alone: the tokens equal."""
    _hold_served(_shallow_cfg(arch, dtype=torch.float64), profile, strict=True)


def _hold_served(cfg, profile, strict=False):
    profile("serve_tp")
    mesh = make_test_mesh(2, 4, device="cpu")
    model = init_params(model_decls(cfg), prng_key(1))
    store = shard_params(model, cfg, mesh)
    rng = np.random.default_rng(2)
    batch = {}
    if cfg.is_encoder_decoder or cfg.modality == "vision":
        batch["frontend_embeds"] = torch.from_numpy(
            rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32))
    key = "dec_tokens" if cfg.is_encoder_decoder else "tokens"
    batch[key] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))
    want = prefill(model, batch, cfg)
    witness = Witness(lambda s: {"logits": _close_err(prefill(nudged(model, s), batch, cfg),
                                                      want)}, strict)
    witness.hold("logits", _close_err(prefill(store, batch, cfg, mesh=mesh), want), 1e-6)
    prompts = batch[key][:, :4]
    fe = batch.get("frontend_embeds") if cfg.is_encoder_decoder else None
    with torch.no_grad():
        want = generate(cfg, model, prompts, 4, frontend_embeds=fe)
        got = generate(cfg, store, prompts, 4, frontend_embeds=fe, mesh=mesh)
    if strict:
        assert torch.equal(got, want)
    for r, i in _first_differences(got, want):
        # The unmeshed logits where the row parts, on the tokens before it.
        part = {key: torch.cat([prompts[r], want[r, :i]])[None]}
        if fe is not None:
            part["frontend_embeds"] = fe[r:r + 1]
        logits = prefill(model, part, cfg)[0]
        shift = max(float((prefill(nudged(model, s), part, cfg)[0] - logits).abs().max())
                    for s in range(NUDGES))
        margin = float(logits[want[r, i]] - logits[got[r, i]])
        assert 0 <= margin <= 2 * WITNESS_K * shift, (r, i, margin, shift)


def _first_differences(got, want):
    """(row, step) where each row's tokens first differ."""
    return [(r, int((g != w).nonzero()[0])) for r, (g, w) in enumerate(zip(got, want))
            if not torch.equal(g, w)]


def test_serve_tp_decode_of_recurrentgemma_steps_equal_unmeshed(profile):
    """The reference's ``test_serve_tp_decode_runs``: reduced recurrentgemma
    (RG-LRU and local attention), ``serve_tp`` on 2 x 4, 8 decode steps,
    logits of each step equal to the unmeshed decode's, both caches alike."""
    _hold_recurrentgemma_decode(_cfg("recurrentgemma-2b"), profile)


def test_serve_tp_decode_of_recurrentgemma_in_float64_holds_the_tolerances(profile):
    """The same in float64, at the tolerances alone."""
    _hold_recurrentgemma_decode(_cfg("recurrentgemma-2b", dtype=torch.float64), profile,
                                strict=True)


def _decode_run(params, cfg, tokens, mesh=None):
    """Each step's (logits, cache) of 8 decode steps fed ``tokens`` [8, B]."""
    cache, out = tfm.init_decode_cache(tokens.shape[1], cfg, 8, "cpu"), []
    for i, tok in enumerate(tokens):
        logits, cache = decode(params, tok[:, None], cache, i, cfg, mesh=mesh)
        out.append((logits, [{k: v.clone() for k, v in c.items()} for c in cache]))
    return out


def _decode_errs(got, want):
    out = {}
    for i, ((lg, cg), (lw, cw)) in enumerate(zip(got, want)):
        out[i] = _close_err(lg, lw)
        out.update({(i, j, k): _close_err(b[k], a[k]) for j, (a, b) in enumerate(zip(cw, cg))
                    for k in a})
    return out


def _hold_recurrentgemma_decode(cfg, profile, strict=False):
    profile("serve_tp")
    mesh = make_test_mesh(2, 4, device="cpu")
    model = init_params(model_decls(cfg), prng_key(4))
    store = shard_params(model, cfg, mesh)
    assert {s.spec for s in param_shardings(cfg, mesh).values()} >= {(None, "model")}
    with torch.no_grad():
        # The unmeshed greedy tokens, fed to every run.
        tok, cache, tokens = torch.arange(4, dtype=torch.int32), None, []
        cache = tfm.init_decode_cache(4, cfg, 8, "cpu")
        for i in range(8):
            tokens.append(tok)
            logits, cache = decode(model, tok[:, None], cache, i, cfg)
            tok = logits.argmax(-1).to(torch.int32)
        tokens = torch.stack(tokens)
        want = _decode_run(model, cfg, tokens)
        witness = Witness(lambda s: _decode_errs(_decode_run(nudged(model, s), cfg, tokens), want),
                          strict)
        for key, err in _decode_errs(_decode_run(store, cfg, tokens, mesh), want).items():
            witness.hold(key, err, 1e-6)


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
