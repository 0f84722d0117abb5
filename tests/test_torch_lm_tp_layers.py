"""The LM layers split over ``model`` against the reference's unmeshed
functions, on the CPU.

Each layer reads its weights from a ``BlockStore`` laid out on a mesh of
``cpu`` repeated under the ``tp`` profile (``sharding/blocks.py``), so each
position of the data shard runs on its own blocks and the results meet in
the model-axis operators (``distributed/collectives.py``); the reference
runs the same layer on the whole weights.  float32, weights of each
layer's own fan-in, numpy inputs from a seed; outputs within 1e-5 (the
layers' tolerance of ``test_torch_lm_layers.py``), MoE balance losses
within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_pair import configs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.core.prng import prng_key
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.specs import model_decls
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.base import init_params
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.blocks import ModelBlocks, lay_out_cache, model_group, shard_params
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

TOL = 1e-5


@pytest.fixture(autouse=True)
def tp_profile():
    tpart.set_profile("tp")
    try:
        yield
    finally:
        tpart.set_profile("tp")


def _split(arch, m, **changes):
    """(reference config, port config, port model, the model's store on a
    (1, m) mesh) for ``arch`` reduced, fp32, fan-in weights."""
    jc, tc = configs(arch, **changes)
    model = init_params(model_decls(tc, fan_in=True), prng_key(0))
    return jc, tc, model, shard_params(model, tc, make_test_mesh(1, m, device="cpu"))


def _j(node) -> dict:
    """A ``ParamTree`` node as the reference's dict of arrays."""
    out = {n: jnp.asarray(p.detach().numpy()) for n, p in node._parameters.items()}
    out.update({n: _j(c) for n, c in node._modules.items()})
    return out


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def _every_position_read(store, m):
    assert sorted(store.local_reads) == [(0, i) for i in range(m)]


@pytest.mark.parametrize("m", (2, 4))
def test_split_mlp_equals_reference(m):
    jc, tc, model, store = _split("h2o-danube-1.8b", m)
    x = _x((2, 8, tc.d_model))
    p = store.view()["layers"][0]["mlp"]
    assert model_group(p, "w_gate", "w_up", "w_down").size == m
    got = tlayers.mlp(p, torch.from_numpy(x))
    _close(got, jlayers.mlp(_j(model.layers[0].mlp), jnp.asarray(x)))
    _every_position_read(store, m)
    assert store.gathered == {}


@pytest.mark.parametrize("arch,m,gathered", [
    ("h2o-danube-1.8b", 2, set()),
    ("h2o-danube-1.8b", 4, set()),
    ("qwen2-vl-7b", 4, set()),
    ("recurrentgemma-2b", 4, {"wk", "wv"}),
], ids=["kv-split-2", "kv-split-4", "mrope-4", "kv-gathered-4"])
def test_split_attention_equals_reference(arch, m, gathered):
    """Query heads split over ``model``; the kv heads split where
    ``n_kv_heads`` divides it, else (reduced recurrentgemma, one kv head on
    4 positions) read whole by every position and recorded."""
    jc, tc, model, store = _split(arch, m)
    i = next(i for i in range(tc.n_layers) if tc.pattern_for_layer(i) == "attn")
    x = _x((2, 8, tc.d_model))
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    if tc.mrope_sections is not None:
        pos = np.broadcast_to(pos, (3, 2, 8))
    window = tc.sliding_window or tc.local_window
    got = tattn.attention_apply(store.view()["layers"][i]["attn"], torch.from_numpy(x), tc,
                                torch.from_numpy(pos.copy()), window=window)
    want = jattn.attention_apply(_j(model.layers[i].attn), jnp.asarray(x), jc, jnp.asarray(pos),
                                 window=window)
    _close(got, want)
    _every_position_read(store, m)
    assert {n.rsplit(".", 1)[1] for n in store.gathered} == gathered
    assert all("n_kv_heads 1 does not divide over model 4" == r for r in store.gathered.values())


def _j_xent(embed, h, t, jc):
    head = embed["tok"].T if jc.tie_embeddings else embed["head"]
    logits = jlayers.softcap((h @ head).astype(jnp.float32), jc.logit_softcap)
    tgt = jnp.take_along_axis(logits, t[..., None], axis=-1)[..., 0]
    return jax.nn.logsumexp(logits, axis=-1) - tgt


@pytest.mark.parametrize("arch,m,split", [
    ("h2o-danube-1.8b", 2, True),
    ("recurrentgemma-2b", 4, True),
    ("seamless-m4t-large-v2", 4, False),
], ids=["untied-2", "tied-softcap-4", "seamless-vocab-whole-4"])
def test_vocab_parallel_embedding_logits_and_cross_entropy(arch, m, split):
    """The embedding, the head and the cross entropy split by vocab entries
    (the tied head of recurrentgemma, with its soft-cap, too); seamless's
    own vocab of 256,206 does not divide over 4 positions, so its leaves
    are held whole and computed whole, with nothing gathered."""
    changes = {"vocab_size": 256206} if arch.startswith("seamless") else {}
    jc, tc, model, store = _split(arch, m, **changes)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tc.vocab_size, (2, 8)).astype(np.int32)
    h = _x((2, 8, tc.d_model), seed=3)
    p = store.view()["embed"]
    assert (model_group(p, "tok") is not None) == split
    je = _j(model.embed)
    _close(tlayers.embed_lookup(p, torch.from_numpy(tokens)),
           jlayers.embed_lookup(je, jnp.asarray(tokens)))
    _close(tlayers.lm_logits(p, torch.from_numpy(h), tc), jlayers.lm_logits(je, jnp.asarray(h), jc))
    ht = torch.from_numpy(h).requires_grad_(True)
    xent = tlayers.token_xent(p, ht, torch.from_numpy(tokens).long(), tc, tc.logit_softcap)
    _close(xent, _j_xent(je, jnp.asarray(h), jnp.asarray(tokens), jc))
    (gh,) = torch.autograd.grad(xent.sum(), ht)
    want = jax.grad(lambda a: _j_xent(je, a, jnp.asarray(tokens), jc).sum())(jnp.asarray(h))
    _close(gh, want)
    assert store.gathered == {}
    if split:
        _every_position_read(store, m)


@pytest.mark.parametrize("arch,m,experts", [
    ("qwen2-moe-a2.7b", 2, 8), ("qwen2-moe-a2.7b", 4, 8), ("phi3.5-moe-42b-a6.6b", 4, 16),
], ids=["ff-split-2", "ff-split-4", "experts-sharded-4"])
def test_split_moe_equals_reference(arch, m, experts):
    """Both of the reference's layouts: experts whole and split by ``ff``
    (with qwen2-moe's shared expert), and phi3.5-moe at 16 experts,
    sharded over ``model``: its declared axes are the reference's
    ``("expert", "fsdp", None)``."""
    jc, tc, model, store = _split(arch, m, n_experts=experts)
    axes = tmoe.moe_decls(tc)["w_gate"].axes
    assert axes == jmoe.moe_decls(jc)["w_gate"].axes
    assert axes == (("expert", "fsdp", None) if experts == 16 else (None, "fsdp", "tensor"))
    p = store.view()["layers"][0]["moe"]
    assert p.model_dims("w_gate") == ((0,) if experts == 16 else (2,))
    x = _x((2, 8, tc.d_model))
    y, aux = tmoe.moe_apply(p, torch.from_numpy(x), tc)
    jy, jaux = jmoe.moe_apply(_j(model.layers[0].moe), jnp.asarray(x), jc)
    _close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    _every_position_read(store, m)
    assert store.gathered == {}


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("arch,kind", [("recurrentgemma-2b", "rglru"), ("xlstm-350m", "mlstm"),
                                       ("xlstm-350m", "slstm")])
def test_split_recurrent_blocks_equal_reference(arch, kind, m):
    """RG-LRU split by channel, mLSTM by heads, sLSTM by units (its
    ``w_in`` read whole by every position and recorded)."""
    jc, tc, model, store = _split(arch, m)
    i = next(i for i in range(tc.n_layers) if tc.pattern_for_layer(i) == kind)
    x = _x((2, 8, tc.d_model))
    fns = {"rglru": (trglru.rglru_apply, jrglru.rglru_apply),
           "mlstm": (tssm.mlstm_apply, jssm.mlstm_apply),
           "slstm": (tssm.slstm_apply, jssm.slstm_apply)}
    t_fn, j_fn = fns[kind]
    got = t_fn(store.view()["layers"][i][kind], torch.from_numpy(x), tc)
    _close(got, j_fn(_j(model.layers[i][kind]), jnp.asarray(x), jc))
    _every_position_read(store, m)
    assert set(store.gathered) == ({f"layers.{i}.slstm.w_in"} if kind == "slstm" else set())


@functools.lru_cache(maxsize=None)
def _j_decode(jc, window):
    return jax.jit(functools.partial(jattn.decode_attention, cfg=jc, window=window))


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "recurrentgemma-2b"))
def test_split_softmax_decode_on_a_wrapped_ring(arch):
    """Decode attention on a ring of 16 slots (the window) split by ``seq``
    over 4 positions, 40 steps, so the ring wraps twice: the new key and
    value go to the position holding slot ``pos % 16``, each position scores
    every head against its own slots, and the partial softmaxes combine
    to the reference's whole-ring decode within 1e-5.  In the first steps
    three positions hold only empty slots and add nothing (no NaN)."""
    jc, tc, model, store = _split(arch, 4)
    i = next(i for i in range(tc.n_layers) if tc.pattern_for_layer(i) == "attn")
    window = tc.sliding_window or tc.local_window
    assert tattn.cache_len(tc, 64) == window == 16
    cache = tattn.init_kv_cache(2, tc, 64, 1, "cpu")
    laid = lay_out_cache(cache, ["attn"], make_test_mesh(1, 4, device="cpu"))
    assert laid.specs["0.k"][2] == "model"
    k = ModelBlocks([laid.blocks["0.k"][(0, j)] for j in range(4)], 2)
    v = ModelBlocks([laid.blocks["0.v"][(0, j)] for j in range(4)], 2)
    jk, jv = (jnp.zeros(cache[0]["k"].shape, jnp.float32) for _ in range(2))
    p, jp = store.view()["layers"][i]["attn"], _j(model.layers[i].attn)
    rng = np.random.default_rng(5)
    for pos in range(40):
        x = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
        out, k, v = tattn.decode_attention(p, torch.from_numpy(x), k, v, pos, tc, window=window)
        want, jk, jv = _j_decode(jc, window)(jp, jnp.asarray(x), jk, jv, jnp.int32(pos))
        assert torch.isfinite(out).all()
        _close(out, want)
    _close(torch.cat(k.blocks, 2), jk)
    _close(torch.cat(v.blocks, 2), jv)
