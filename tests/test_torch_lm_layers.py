"""Port vs reference: the LM substrate's layers and blocks, in float32.

Layers at rtol = atol = 1e-5: RMSNorm, soft-capping, RoPE, M-RoPE (and
text M-RoPE equal to RoPE), the gated MLP (SiLU and the tanh GELU),
chunked attention (causal, windowed, ``q_offset``, several chunks, a
ragged length, GQA), decode attention across two ring wraps, and the MoE
layer with its aux loss (routed with and without a shared expert, and the
capacity-drop case).  Recurrent blocks at 1e-4, the reference's own
tolerance for its scan: RG-LRU (full sequence and step by step), mLSTM at
chunks 4, 8 and 16 and step by step, sLSTM (full sequence and step by
step).  Weights are the reference's ``init_params`` draws, copied across.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_pair import configs, f32

from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models.base import init_params as j_init
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.models.base import ParamTree
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

TOL = 1e-5
REC_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _pair(jdecls, tdecls, seed=0):
    """(reference params, port tree) of one block, the same draws."""
    params = j_init({"x": jdecls}, jax.random.PRNGKey(seed))["x"]
    tree = ParamTree(tdecls)

    def copy(node, arrays):
        for k, v in arrays.items():
            if isinstance(v, dict):
                copy(node[k], v)
            else:
                node[k].copy_(torch.from_numpy(np.array(v)))

    copy(tree, params)
    return params, tree


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_softcap():
    params, tree = _pair(jl.rmsnorm_decls(64), tl.rmsnorm_decls(64))
    scale = _x((64,), 1)
    params = {"scale": jnp.asarray(scale)}
    tree["scale"].copy_(torch.from_numpy(scale))
    x = _x((2, 5, 64), 2, 3.0)
    _close(tl.rmsnorm(tree, torch.from_numpy(x), 1e-6), jl.rmsnorm(params, jnp.asarray(x), 1e-6))
    y = _x((3, 100), 3, 40.0)
    _close(tl.softcap(torch.from_numpy(y), 30.0), jl.softcap(jnp.asarray(y), 30.0))
    assert tl.softcap(torch.from_numpy(y), None) is not None
    _close(tl.softcap(torch.from_numpy(y), None), y)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    x = _x((2, 7, 4, 16), 4)
    pos = np.arange(3, 10, dtype=np.int32)[None].repeat(2, 0)
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # Positions given as [S].
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos[0]), theta),
           jl.rope(jnp.asarray(x), jnp.asarray(pos[0]), theta))


def test_mrope_matches_reference_and_text_mrope_equals_rope():
    x = _x((2, 6, 4, 16), 8)
    rng = np.random.default_rng(9)
    pos3 = rng.integers(0, 50, (3, 2, 6)).astype(np.int32)
    _close(tl.mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6, (2, 3, 3)),
           jl.mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (2, 3, 3)))
    pos = torch.arange(6).expand(2, 6)
    _close(tl.mrope(torch.from_numpy(x), pos.expand(3, 2, 6), 1e4, (2, 3, 3)),
           tl.rope(torch.from_numpy(x), pos, 1e4))
    with pytest.raises(ValueError, match="mrope sections"):
        tl.mrope(torch.from_numpy(x), pos.expand(3, 2, 6), 1e4, (2, 3, 4))


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_matches_reference(activation):
    params, tree = _pair(jl.mlp_decls(64, 128, jnp.float32), tl.mlp_decls(64, 128, torch.float32))
    x = _x((2, 5, 64), 5)
    _close(tl.mlp(tree, torch.from_numpy(x), activation),
           jl.mlp(params, jnp.asarray(x), activation))


@pytest.mark.parametrize("tied", [True, False])
def test_embedding_and_lm_head(tied):
    jc, tc = configs("xlstm-350m" if tied else "h2o-danube-1.8b")
    params, tree = _pair(jl.embed_decls(jc), tl.embed_decls(tc))
    toks = np.random.default_rng(1).integers(0, 512, (2, 5)).astype(np.int32)
    h = _x((2, 5, 64), 6)
    _close(tl.embed_lookup(tree, torch.from_numpy(toks)),
           jl.embed_lookup(params, jnp.asarray(toks)), 0)
    _close(tl.lm_logits(tree, torch.from_numpy(h), tc), jl.lm_logits(params, jnp.asarray(h), jc))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(sq=16, sk=16, causal=True),
    dict(sq=16, sk=16, causal=True, window=5),
    dict(sq=16, sk=16, causal=False),
    dict(sq=6, sk=16, causal=True, q_offset=10),
    dict(sq=24, sk=24, causal=True, window=7, chunk=8),
    dict(sq=13, sk=13, causal=True, chunk=4),
], ids=["causal", "windowed", "bidirectional", "q_offset", "three-chunks", "ragged"])
def test_chunked_attention_matches_reference(case):
    case = dict(case)
    sq, sk = case.pop("sq"), case.pop("sk")
    q, k, v = _x((2, 4, sq, 16), 10), _x((2, 2, sk, 16), 11), _x((2, 2, sk, 16), 12)
    _close(tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **case),
           jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **case))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-vl-7b"])
def test_attention_apply_matches_reference(arch):
    jc, tc = configs(arch)
    params, tree = _pair(jattn.attention_decls(jc), tattn.attention_decls(tc))
    x = _x((2, 20, 64), 13)
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    if jc.mrope_sections:
        pos = np.stack([pos, pos // 2, pos % 5])
    for kw in (dict(window=6), dict(causal=False)):
        _close(tattn.attention_apply(tree, torch.from_numpy(x), tc, torch.from_numpy(pos), **kw),
               jattn.attention_apply(params, jnp.asarray(x), jc, jnp.asarray(pos), **kw))
    src = _x((2, 9, 64), 14)
    _close(tattn.attention_apply(tree, torch.from_numpy(x), tc, torch.from_numpy(pos),
                                 kv_source=torch.from_numpy(src)),
           jattn.attention_apply(params, jnp.asarray(x), jc, jnp.asarray(pos),
                                 kv_source=jnp.asarray(src)))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-vl-7b"])
def test_decode_attention_across_ring_wraps(arch):
    """A 6-slot ring over 15 positions (two wraps) with a window of 6, one
    step at a time on both sides; the port writes its cache in place."""
    jc, tc = configs(arch, sliding_window=6)
    params, tree = _pair(jattn.attention_decls(jc), tattn.attention_decls(tc))
    jcache = jattn.init_kv_cache(2, jc, 15, 1)
    jk, jv = jcache["k"][0], jcache["v"][0]
    tcache = tattn.init_kv_cache(2, tc, 15, 1)[0]
    assert tuple(tcache["k"].shape) == tuple(jk.shape) == (2, jc.n_kv_heads, 6, 16)
    xs = _x((15, 2, 1, 64), 15)
    for i in range(15):
        want, jk, jv = jattn.decode_attention(params, jnp.asarray(xs[i]), jk, jv,
                                              jnp.int32(i), jc, window=6)
        got, tk, tv = tattn.decode_attention(tree, torch.from_numpy(xs[i]), tcache["k"],
                                             tcache["v"], i, tc, window=6)
        assert tk is tcache["k"]
        _close(got, want)
        _close(tk, jk)
        _close(tv, jv)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,changes,shape,scale", [
    ("qwen2-moe-a2.7b", {}, (2, 64, 64), 0.5),
    ("phi3.5-moe-42b-a6.6b", {}, (2, 40, 64), 1.0),
    ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.01}, (1, 64, 64), 1.0),
    ("qwen2-moe-a2.7b", {}, (3, 1, 64), 1.0),
], ids=["shared-expert", "routed-ragged-groups", "capacity-drop", "decode-token"])
def test_moe_matches_reference_with_aux_loss(arch, changes, shape, scale):
    jc, tc = configs(arch, **changes)
    params, tree = _pair(jmoe.moe_decls(jc), tmoe.moe_decls(tc))
    x = _x(shape, 7, scale)
    want, jaux = jmoe.moe_apply(params, jnp.asarray(x), jc)
    got, taux = tmoe.moe_apply(tree, torch.from_numpy(x), tc)
    _close(got, want)
    _close(taux, jaux)
    assert np.isfinite(f32(got)).all() and 0 < float(taux) < 10


def test_moe_capacity_drop_leaves_only_the_overflow_out():
    """At capacity 4 of 64 tokens per expert, most routed assignments drop
    (their rows are zero, not an error), and the layer's output equals
    the reference's."""
    jc, tc = configs("phi3.5-moe-42b-a6.6b", capacity_factor=0.01)
    _, tree = _pair(jmoe.moe_decls(jc), tmoe.moe_decls(tc))
    y, _ = tmoe.moe_apply(tree, torch.from_numpy(_x((1, 64, 64), 7)), tc)
    zero_rows = int((y.abs().sum(-1) == 0).sum())
    assert zero_rows >= 64 - 8 * 4     # at most 4 slots for each of 8 experts


# ---------------------------------------------------------------------------
# Recurrent blocks
# ---------------------------------------------------------------------------

def test_rglru_full_sequence_and_steps_match_reference():
    jc, tc = configs("recurrentgemma-2b")
    params, tree = _pair(jrg.rglru_decls(jc), trg.rglru_decls(tc))
    x = _x((2, 10, 64), 4, 0.1)
    y = trg.rglru_apply(tree, torch.from_numpy(x), tc)
    _close(y, jrg.rglru_apply(params, jnp.asarray(x), jc), REC_TOL)
    jst, tst = jrg.rglru_init_state(2, jc), trg.rglru_init_state(2, tc)
    outs = []
    for i in range(10):
        jy, jst = jrg.rglru_decode(params, jnp.asarray(x[:, i : i + 1]), jst, jc)
        ty, tst = trg.rglru_decode(tree, torch.from_numpy(x[:, i : i + 1]), tst, tc)
        _close(ty, jy, REC_TOL)
        _close(tst["h"], jst["h"], REC_TOL)
        _close(tst["conv"], jst["conv"], REC_TOL)
        outs.append(f32(ty))
    _close(np.concatenate(outs, 1), y, REC_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunkwise_matches_reference(chunk):
    jc, tc = configs("xlstm-350m")
    params, tree = _pair(jssm.mlstm_decls(jc), tssm.mlstm_decls(tc))
    x = _x((2, 16, 64), 3, 0.1)
    want = jssm.mlstm_apply(params, jnp.asarray(x), jc, chunk=chunk)
    _close(tssm.mlstm_apply(tree, torch.from_numpy(x), tc, chunk=chunk), want, REC_TOL)
    # Chunk-size invariance, as the reference holds it.
    _close(tssm.mlstm_apply(tree, torch.from_numpy(x), tc, chunk=16), want, REC_TOL)


def test_mlstm_steps_match_reference_and_the_chunked_form():
    jc, tc = configs("xlstm-350m")
    params, tree = _pair(jssm.mlstm_decls(jc), tssm.mlstm_decls(tc))
    x = _x((2, 8, 64), 5, 0.1)
    jst, tst = jssm.mlstm_init_state(2, jc), tssm.mlstm_init_state(2, tc)
    outs = []
    for i in range(8):
        jy, jst = jssm.mlstm_decode(params, jnp.asarray(x[:, i : i + 1]), jst, jc)
        ty, tst = tssm.mlstm_decode(tree, torch.from_numpy(x[:, i : i + 1]), tst, tc)
        _close(ty, jy, REC_TOL)
        for name in ("C", "n", "m"):
            _close(tst[name], jst[name], REC_TOL)
        outs.append(f32(ty))
    _close(np.concatenate(outs, 1), tssm.mlstm_apply(tree, torch.from_numpy(x), tc, chunk=8),
           REC_TOL)


@pytest.mark.parametrize("d_ff", [0, 128], ids=["no-ffn", "ffn"])
def test_slstm_full_sequence_and_steps_match_reference(d_ff):
    jc, tc = configs("xlstm-350m", d_ff=d_ff)
    params, tree = _pair(jssm.slstm_decls(jc), tssm.slstm_decls(tc))
    assert ("ffn" in tree) == bool(d_ff)
    x = _x((2, 9, 64), 6, 0.5)
    y = tssm.slstm_apply(tree, torch.from_numpy(x), tc)
    _close(y, jssm.slstm_apply(params, jnp.asarray(x), jc), REC_TOL)
    jst, tst = jssm.slstm_init_state(2, jc), tssm.slstm_init_state(2, tc)
    outs = []
    for i in range(9):
        jy, jst = jssm.slstm_decode(params, jnp.asarray(x[:, i : i + 1]), jst, jc)
        ty, tst = tssm.slstm_decode(tree, torch.from_numpy(x[:, i : i + 1]), tst, tc)
        _close(ty, jy, REC_TOL)
        outs.append(f32(ty))
    _close(np.concatenate(outs, 1), y, REC_TOL)


def test_conv1d_with_history_matches_reference():
    jc, tc = configs("recurrentgemma-2b")
    jc, tc = (dataclasses.replace(c, conv_width=3) for c in (jc, tc))
    params, tree = _pair(jrg.rglru_decls(jc), trg.rglru_decls(tc))
    x, hist = _x((2, 5, 64), 1), _x((2, 2, 64), 2)
    _close(trg._conv1d(tree, torch.from_numpy(x), torch.from_numpy(hist)),
           jrg._conv1d(params, jnp.asarray(x), jnp.asarray(hist)))
    _close(trg._conv1d(tree, torch.from_numpy(x), None), jrg._conv1d(params, jnp.asarray(x), None))
