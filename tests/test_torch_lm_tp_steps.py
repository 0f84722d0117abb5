"""Tensor- and expert-parallel LM steps against the unmeshed port and the
reference, on the CPU.

Meshes are ``cpu`` repeated; ``tp`` splits the ``tensor`` and ``expert``
dims over ``model`` and ZeRO-shards over ``data``, ``serve_tp`` splits over
``model`` only.  float32 on weights of each layer's own fan-in, numpy
inputs from a seed, at ``test_torch_lm_mesh.py``'s tolerances against the
unmeshed port (loss 1e-6, grad_norm 1e-5, each gradient leaf within 1e-5 of
its largest entry) and ``test_torch_lm_train.py``'s against the reference
(loss 1e-5, gradients 1e-4).  xLSTM runs its 3-layer stack, as both of
those files hold it under a split.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_pair import batch as np_batch
from _lm_pair import configs, ref_params, to_jax, to_torch
from test_torch_lm_mesh import XLSTM_SHALLOW, _cfg, _hold_grads, _hold_steps, _matching, _tcfg
from test_torch_lm_train import j_value_and_grad
from repro_torch.configs import ShapeConfig, paired_archs
from repro_torch.convert import lm_state_to_arrays
from repro_torch.core.prng import prng_key
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.specs import cache_shardings, cache_specs, model_decls
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.blocks import shard_params
from repro_torch.train.serve_step import decode
from repro_torch.train.train_step import loss_and_grads
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")


@pytest.fixture
def profile():
    try:
        yield tpart.set_profile
    finally:
        tpart.set_profile("tp")


def _split_arch(arch):
    return XLSTM_SHALLOW if arch == "xlstm-350m" else {}


def _grads_both(arch, shape):
    """(config, store, the meshed and the unmeshed (loss, grads)) of one
    batch of 4 x 16 under ``tp`` on a ``shape`` mesh, at the unmeshed
    microbatch count that adds the same per-shard sums."""
    cfg = _cfg(arch, **_split_arch(arch))
    model = init_params(model_decls(cfg, fan_in=True), prng_key(0))
    mesh = make_test_mesh(*shape, device="cpu")
    store = shard_params(model, cfg, mesh)
    data = to_torch(np_batch(cfg, b=4, s=16, seed=3), cfg)
    flat = loss_and_grads(cfg, _tcfg(microbatches=_matching(cfg, 1, shape[0])),
                          copy.deepcopy(model), data)
    meshed = loss_and_grads(cfg, _tcfg(microbatches=1), store, data, mesh=mesh)
    return cfg, model, store, data, meshed, flat


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
                                  "xlstm-350m", "seamless-m4t-large-v2"))
def test_replicated_leaves_get_their_gradient_once(arch, profile):
    """A leaf replicated over ``model`` (norm scales, ``router``,
    ``shared_mix``, ``lambda_p``, ``w_if``/``b_if``, ``r_rec``/``b``) is read
    by the data shard's first position or, where a split layer uses a slice
    of it, by every position; the positions' gradients summed into its
    holder give the unmeshed gradient, not 1/M or M times it.  Every leaf's
    gradient and the loss also hold against the reference's."""
    profile("tp")
    cfg, model, store, data, (lg, gg), (lw, gw) = _grads_both(arch, (2, 2))
    assert abs(float(lg) - float(lw)) <= 1e-6 * abs(float(lw))
    replicated = [n for n in gg if not store.model_dims(n)]
    assert len(replicated) >= 3
    _hold_grads({n: gg[n] for n in replicated}, {n: gw[n] for n in replicated})
    _hold_grads(gg, gw)
    jc, _ = configs(arch, **_split_arch(arch))
    want, jgrads = j_value_and_grad(jc)(jax.tree.map(jnp.asarray, ref_params(model, cfg)),
                                        to_jax(np_batch(cfg, b=4, s=16, seed=3), jc))
    assert abs(float(lg) - float(want)) <= 1e-5 * abs(float(want))
    got = lm_state_to_arrays({"grads": gg}, cfg)["grads"]
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        node = got
        for k in path:
            node = node[k.key]
        g = np.asarray(g)
        assert float(np.abs(node.numpy() - g).max()) <= 1e-4 * float(np.abs(g).max()), path


def test_one_shard_at_one_microbatch_sums_every_positions_gradient(profile):
    """A (1, 2) ``tp`` mesh at microbatches 1: one shard and one microbatch,
    so each gradient stays in its leaf's dtype, and a leaf that both
    positions read (xLSTM's replicated ``b_if``, norm scales) gets both
    positions' gradients.  Every leaf holds against the unmeshed gradient."""
    profile("tp")
    cfg, model, store, data, (lg, gg), (lw, gw) = _grads_both("xlstm-350m", (1, 2))
    assert abs(float(lg) - float(lw)) <= 1e-6 * abs(float(lw))
    assert any(n.endswith("b_if") and not store.model_dims(n) for n in gg)
    _hold_grads(gg, gw)


@pytest.mark.parametrize("shape", ((2, 2), (2, 4)), ids=["2x2", "2x4"])
@pytest.mark.parametrize("arch", paired_archs())
def test_tp_gathers_across_model_only_what_does_not_split(arch, shape, profile):
    """Under ``tp`` every position of a data shard reads its own blocks, and
    no ``tensor``- or ``expert``-sharded leaf is gathered across ``model``
    where it splits into whole heads, units, vocab entries or experts.
    What is gathered, with the reason: reduced recurrentgemma's ``wk``/``wv``
    (one kv head) and the sLSTM's ``w_in`` (its ``[z, i, f, o]`` columns)."""
    profile("tp")
    cfg = _cfg(arch, **_split_arch(arch))
    model = init_params(model_decls(cfg, fan_in=True), prng_key(0))
    mesh = make_test_mesh(*shape, device="cpu")
    store = shard_params(model, cfg, mesh)
    data = to_torch(np_batch(cfg, b=4, s=16, seed=3), cfg)
    loss_and_grads(cfg, _tcfg(microbatches=1), store, data, mesh=mesh)
    assert set(store.local_reads) == set(store.positions)
    want = set()
    if arch == "recurrentgemma-2b":
        want = {f"layers.{i}.attn.{k}" for i in range(cfg.n_layers)
                if cfg.pattern_for_layer(i) == "attn" for k in ("wk", "wv")}
    if arch == "xlstm-350m":
        want = {f"layers.{i}.slstm.w_in" for i in range(cfg.n_layers)
                if cfg.pattern_for_layer(i) == "slstm"}
    assert set(store.gathered) == want, store.gathered


def test_expert_parallel_train_step_equals_unmeshed(profile):
    """Reduced phi3.5-moe at 16 experts, sharded over ``model`` on a (2, 2)
    ``tp`` mesh: 3 steps against the unmeshed step (its routing groups and
    balance loss the whole microbatch's, counted once)."""
    profile("tp")
    cfg = _cfg("phi3.5-moe-42b-a6.6b", n_experts=16)
    mesh = make_test_mesh(2, 2, device="cpu")
    _, meshed = _hold_steps(cfg, _tcfg(microbatches=1), _tcfg(microbatches=1), mesh)
    store = meshed["params"]
    assert store.model_dims("layers.0.moe.w_gate") == (0,)
    assert store.blocks["layers.0.moe.w_gate"][(0, 1)].shape[0] == 8
    assert store.gathered == {}


def test_serve_tp_decode_with_a_cache_laid_out_by_cache_shardings(profile):
    """The reference's ``test_serve_tp_decode_runs`` with the cache laid out
    as its ``cache_shardings`` lay it out: reduced recurrentgemma on a
    (2, 4) ``serve_tp`` mesh, attention ``k``/``v`` split by ``seq``, the
    RG-LRU state by channel.  8 decode steps: logits within 1e-5 of the
    unmeshed decode and the same greedy tokens; each position holds the
    dry-run's cache bytes for this mesh and shape."""
    profile("serve_tp")
    cfg = _cfg("recurrentgemma-2b")
    mesh = make_test_mesh(2, 4, device="cpu")
    model = init_params(model_decls(cfg), prng_key(4))
    store = shard_params(model, cfg, mesh)
    cache = tfm.init_decode_cache(4, cfg, 8, mesh=mesh)
    shape = ShapeConfig("decode", 8, 4, "decode")
    want_specs = cache_shardings(cfg, shape, mesh)
    for i, node in enumerate(cache.tree):
        for leaf, name in node.items():
            assert cache.specs[name] == want_specs[i][leaf].spec, name
    assert cache.specs["2.k"][2] == "model" and cache.specs["0.h"][1] == "model"
    per_position = dryrun.shard_bytes(cache_specs(cfg, shape), want_specs)
    assert [cache.nbytes_at(p) for p in cache.positions] == [per_position] * 8
    flat = tfm.init_decode_cache(4, cfg, 8, "cpu")
    tok0 = tok1 = torch.arange(4, dtype=torch.int32)[:, None]
    with torch.no_grad():
        for i in range(8):
            l0, flat = decode(model, tok0, flat, i, cfg)
            l1, cache = decode(store, tok1, cache, i, cfg, mesh=mesh)
            assert float((l1 - l0).abs().max()) <= 1e-5 * max(float(l0.abs().max()), 1.0)
            tok0, tok1 = (t.argmax(-1).to(torch.int32)[:, None] for t in (l0, l1))
            assert torch.equal(tok1, tok0)
    assert set(store.local_reads) == set(store.positions)
    assert store.gathered == {k: "n_kv_heads 1 does not divide over model 4"
                              for k in store.gathered}
    for i, layer in enumerate(flat):
        for leaf, t in layer.items():
            assert float((cache.full(f"{i}.{leaf}") - t).abs().max()) <= 1e-5 * max(
                float(t.abs().max()), 1.0)
