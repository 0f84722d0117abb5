"""Port vs reference: the LM serving path.

``prefill`` for token-only, vision-frontend and encoder-decoder batches;
``sample_tokens`` greedy with latched EOS and pad, and at a temperature
from a key (``jax.random.categorical``'s tokens); greedy ``generate``
token for token for h2o-danube, qwen2-moe and seamless (batch 2, prompt 8,
6 new tokens), each step's top-2 margin more than ten times the logits'
tolerance so an equal token means something, and sampled ``generate``
from one seed in float32 and bfloat16; the parameter round trip through
``convert``; the launcher in a subprocess on the CPU, and its refusal to
run on the CPU unasked.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_pair import (batch, configs, f32, j_decode_step, models, ref_params, to_jax,
                      to_torch)

from repro.core.cotm import CoTMConfig as JCoTMConfig
from repro.core.cotm import CoTMModel as JCoTMModel
from repro.core.patches import PatchSpec as JPatchSpec
from repro.core.patches import extract_patch_features as j_features
from repro.core.patches import make_literals as j_literals
from repro.core.patches import pack_bits as j_pack
from repro.launch.serve import generate as j_generate
from repro.models import encdec as jed
from repro.models import transformer as jtfm
from repro.serve.servable import freeze as j_freeze
from repro.train import serve_step as jss
from repro_torch import generate
from repro_torch.convert import (
    lm_params_from_arrays,
    model_from_arrays,
    words_from_uint32,
)
from repro_torch.core import prng
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.prng import prng_key
from repro_torch.core.patches import PatchSpec
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm
from repro_torch.serve.servable import freeze
from repro_torch.train import serve_step as tss
from test_torch_prng import one_thread_module  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread_module")

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-3


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-vl-7b", "seamless-m4t-large-v2",
                                  "recurrentgemma-2b"])
def test_prefill_matches_reference(arch):
    jc, tc = configs(arch)
    params, model = models(jc, tc)
    data = batch(jc, b=2, s=16, seed=4)
    want = jss.prefill(params, to_jax(data, jc), jc)
    got = tss.prefill(model, to_torch(data, tc), tc)
    assert got.shape == (2, tc.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL, atol=TOL)


def test_sample_tokens_greedy_latches_eos_and_pads_like_the_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((5, 7)).astype(np.float32)
    logits[1, 2] = 9.0                                    # row 1 emits EOS (2)
    logits[3, [4, 6]] = 9.0                               # a tie: the first wins
    done = np.array([False, False, True, False, False])
    j_tok, j_done = jss.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits),
                                      done=jnp.asarray(done))
    t_tok, t_done = tss.sample_tokens(None, torch.from_numpy(logits), done=torch.from_numpy(done))
    assert t_tok.dtype == torch.int32
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    assert t_tok[2] == 0 and t_tok[3] == 4 and bool(t_done[1])
    # No done given: nothing latched before this step.
    t_tok, t_done = tss.sample_tokens(None, torch.from_numpy(logits))
    j_tok, j_done = jss.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits))
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_temperature_sampling_equals_the_references_tokens(dtype):
    """``sample_tokens`` at a temperature is ``jax.random.categorical`` of
    the key: on the same logits (float32, and bfloat16, whose Gumbel noise
    takes 8 random bits), the reference's tokens wherever the top two
    scores lie more than 2 ulp apart (elsewhere the logs' last place
    decides); a key repeats its tokens, greedy needs none."""
    logits = np.random.default_rng(6).standard_normal((64, 512)).astype(np.float32)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    got, _ = tss.sample_tokens(prng_key(3), tl, temperature=0.8)
    want, _ = jss.sample_tokens(jax.random.PRNGKey(3), jl, temperature=0.8)
    scores = (prng.gumbel(prng_key(3), tl.shape, tl.dtype) + tl / 0.8).float().numpy()
    top = np.sort(scores, axis=-1)
    ulp = np.spacing(np.abs(top[:, -1])) * (1 if dtype == "float32" else 2.0 ** 16)
    clear = top[:, -1] - top[:, -2] > 2 * ulp
    assert clear.mean() > 0.75 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(want)[clear])
    again, _ = tss.sample_tokens(prng_key(3), tl, temperature=0.8)
    greedy, _ = tss.sample_tokens(None, tl)
    assert torch.equal(got, again) and not torch.equal(got, greedy)


def _sampled_margins(jc, params, prompts, gen_len, temperature, seed):
    """The reference's ``generate`` at ``temperature``, step by step: the
    tokens and each step's top-2 margin of the Gumbel scores."""
    b, plen = prompts.shape
    step = j_decode_step(jc)
    cache = jtfm.init_decode_cache(b, jc, plen + gen_len)
    for i in range(plen):
        logits, cache = step(params, jnp.asarray(prompts[:, i : i + 1]), cache, jnp.int32(i))
    key, toks, margins = jax.random.PRNGKey(seed), [], []
    for j in range(gen_len):
        key, k = jax.random.split(key)
        scores = f32(jax.random.gumbel(k, logits.shape, logits.dtype) + logits / temperature)
        top2 = np.sort(scores, -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(scores.argmax(-1).astype(np.int32))
        logits, cache = step(params, jnp.asarray(toks[-1][:, None]), cache, jnp.int32(plen + j))
    return np.stack(toks, 1), np.stack(margins, 1)


@pytest.mark.parametrize("dtype,margin", [("float32", 10 * TOL), ("bfloat16", 0.5)])
def test_temperature_generate_tokens_equal_reference(dtype, margin):
    """``generate`` at temperature 1 from one seed emits the reference's
    tokens (reduced h2o-danube): its key chain ``key, k = split(key)`` per
    token and ``categorical``.  As for greedy decoding, the prompts are the
    first seeded ones whose reference run keeps every step's top-2 score
    margin above ``margin`` (ten times the float32 tolerance; in bfloat16,
    where the packages' logits lie up to ~0.1 apart, 0.5), so that the
    packages' logits, not rounding, choose."""
    jc, tc = configs("h2o-danube-1.8b", dtype)
    params, model = models(jc, tc)
    for seed in range(40):
        prompts = np.random.default_rng(seed).integers(0, jc.vocab_size, (1, 6)).astype(np.int32)
        want, margins = _sampled_margins(jc, params, prompts, 4, 1.0, seed)
        if (margins > margin).all():
            break
    assert (margins > margin).all(), margins
    ref = np.asarray(j_generate(jc, params, jnp.asarray(prompts), 4, temperature=1.0, seed=seed))
    np.testing.assert_array_equal(ref, want)
    got = generate(tc, model, torch.from_numpy(prompts), 4, temperature=1.0, seed=seed)
    np.testing.assert_array_equal(got.numpy(), want)


def _greedy_margins(jc, params, prompts, gen_len, fe):
    """The reference's greedy decode, step by step as its ``generate``
    runs it: the tokens and each sampling step's top-2 logit margin."""
    b, plen = prompts.shape
    step = j_decode_step(jc)
    if jc.is_encoder_decoder:
        cross = jed.prepare_cross_cache(params, jed.encode(params, jnp.asarray(fe), jc,
                                                           remat=False), jc)
        cache = jed.init_self_cache(b, jc, plen + gen_len)
        dec = lambda t, c, i: step(params, t, c, cross, jnp.int32(i))  # noqa: E731
    else:
        cache = jtfm.init_decode_cache(b, jc, plen + gen_len)
        dec = lambda t, c, i: step(params, t, c, jnp.int32(i))  # noqa: E731
    for i in range(plen):
        logits, cache = dec(jnp.asarray(prompts[:, i : i + 1]), cache, i)
    toks, margins = [], []
    for j in range(gen_len):
        lg = f32(logits)
        top2 = np.sort(lg, -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(lg.argmax(-1).astype(np.int32))
        logits, cache = dec(jnp.asarray(toks[-1][:, None]), cache, plen + j)
    return np.stack(toks, 1), np.stack(margins, 1)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2"])
def test_greedy_generate_tokens_equal_reference(arch):
    """Random weights leave some steps with near-tied top logits, where an
    equal token would prove nothing; the prompts are the first seeded ones
    (seeds 0, 1, ...) whose reference run has every step's top-2 margin
    above ten times the tolerance.  Only the reference's logits choose."""
    jc, tc = configs(arch)
    params, model = models(jc, tc)
    for seed in range(20):
        rng = np.random.default_rng(seed)
        prompts = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
        fe = (rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
              if jc.is_encoder_decoder else None)
        want, margins = _greedy_margins(jc, params, prompts, 6, fe)
        if (margins > 10 * TOL).all():
            break
    assert (margins > 10 * TOL).all(), margins
    ref = np.asarray(j_generate(jc, params, jnp.asarray(prompts), 6,
                                frontend_embeds=None if fe is None else jnp.asarray(fe)))
    np.testing.assert_array_equal(ref, want)
    got = generate(tc, model, torch.from_numpy(prompts), 6,
                   frontend_embeds=None if fe is None else torch.from_numpy(fe))
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_fns_equal_the_steps():
    jc, tc = configs("h2o-danube-1.8b")
    _, model = models(jc, tc)
    prefill_fn, decode_fn = tss.make_serve_fns(tc)
    data = to_torch(batch(jc, b=2, s=8), tc)
    assert torch.equal(prefill_fn(model, data), tss.prefill(model, data, tc))
    a, _ = decode_fn(model, data["tokens"][:, :1], ttfm.init_decode_cache(2, tc, 4), 0)
    b, _ = tss.decode(model, data["tokens"][:, :1], ttfm.init_decode_cache(2, tc, 4), 0, tc)
    assert torch.equal(a, b)


def test_make_tm_serve_fn_matches_the_reference():

    geo = dict(image_x=8, image_y=8, window_x=4, window_y=4)
    jcfg = JCoTMConfig(n_clauses=16, n_classes=4, patch=JPatchSpec(**geo))
    tcfg = CoTMConfig(n_clauses=16, n_classes=4, patch=PatchSpec(**geo))
    rng = np.random.default_rng(9)
    n_lit = tcfg.patch.n_literals
    ta = np.where(rng.random((16, n_lit)) < 2.0 / n_lit, 200, 50).astype(np.uint8)
    w = rng.integers(-20, 20, (4, 16)).astype(np.int32)
    imgs = rng.random((5, 8, 8)) < 0.4
    lp = np.asarray(j_pack(j_literals(j_features(jnp.asarray(imgs), jcfg.patch))))
    p, v = jss.make_tm_serve_fn(j_freeze(JCoTMModel(jnp.asarray(ta), jnp.asarray(w)), jcfg),
                                path="bitpacked")(jnp.asarray(lp))
    out = tss.make_tm_serve_fn(freeze(model_from_arrays(ta, w), tcfg), path="bitpacked")(
        words_from_uint32(lp))
    np.testing.assert_array_equal(out[:, 0].numpy(), np.asarray(p))
    np.testing.assert_array_equal(out[:, 1:].numpy(), np.asarray(v))
    with pytest.raises(KeyError, match="unknown eval path"):
        tss.make_tm_serve_fn(freeze(model_from_arrays(ta, w), tcfg), path="bogus")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "xlstm-350m", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_parameter_round_trip_is_exact(arch):
    """The reference's bfloat16 tree -> the port -> the reference's tree,
    bit for bit and dtype for dtype (stacked cycles, tails, enc/dec)."""
    jc, tc = configs(arch, "bfloat16")
    params, _ = models(jc, tc)
    arrays = jax.tree.map(np.asarray, params)
    back = ref_params(lm_params_from_arrays(tc, arrays, device="cpu"), tc)
    same = jax.tree.map(lambda a, b: a.dtype == b.dtype and a.shape == b.shape
                        and np.array_equal(a.view(np.uint8), b.view(np.uint8)), arrays, back)
    assert all(jax.tree.leaves(same))
    # dtype= takes the weights to another dtype; the fixed-float32 leaves stay.
    m32 = lm_params_from_arrays(tc, arrays, device="cpu", dtype=torch.float32)
    assert {p.dtype for p in m32.parameters()} == {torch.float32}
    bad = {**arrays, "embed": {**arrays["embed"], "tok": np.zeros((3, 64), np.float32)}}
    with pytest.raises(ValueError, match="embed/tok"):
        lm_params_from_arrays(tc, bad, device="cpu")


def test_launcher_generates_on_the_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "xlstm-350m",
                        "--reduced", "--device", "cpu", "--gen", "4", "--batch", "2",
                        "--prompt-len", "4"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "generated (2, 4)" in r.stdout and "tok/s" in r.stdout
    assert '"device": "cpu"' in r.stdout.splitlines()[-1]


def test_lm_entry_point_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_lm("xlstm-350m", reduced=True, gen=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--gen", "1"])
