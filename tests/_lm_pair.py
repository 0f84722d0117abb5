"""Shared set-up of the LM port tests (``test_torch_lm_*.py``): one arch's
reduced config on both sides, the reference's weights carried into the
port, seeded numpy inputs, and the reference's jitted steps.

Weights come from the reference's ``init_params`` (``jax.random``) and
cross through ``convert.lm_params_from_arrays``, so both packages hold the
same numbers; inputs are drawn with numpy and handed to each side.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced_config as j_reduced
from repro.launch import specs as JS
from repro.models import encdec as jed
from repro.models import transformer as jtfm
from repro.models.base import init_params as j_init
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import lm_params_from_arrays, lm_state_to_arrays

ARCH_NAMES = sorted(ARCHS)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def configs(arch: str, dtype: str = "float32", **changes):
    """(reference config, port config): ``arch`` reduced, in ``dtype``, with
    the same ``changes`` on both sides."""
    jd, td = DTYPES[dtype]
    jc = dataclasses.replace(j_reduced(J_ARCHS[arch]), dtype=jd, **changes)
    tc = dataclasses.replace(reduced_config(ARCHS[arch]), dtype=td, **changes)
    return jc, tc


def models(jc, tc, seed: int = 0):
    """(reference params, port model) holding the same weights."""
    params = j_init(JS.model_decls(jc), jax.random.PRNGKey(seed))
    return params, lm_params_from_arrays(tc, jax.tree.map(np.asarray, params), device="cpu")


def np_leaf(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, a bfloat16 one by its bits as ``ml_dtypes``'
    bfloat16 (which JAX loads)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def ref_params(model, tc) -> dict:
    """The reference's parameter tree of the port's ``model``, as numpy
    (``convert.lm_state_to_arrays`` of the model alone)."""
    return jax.tree.map(np_leaf, lm_state_to_arrays({"params": model}, tc)["params"])


def batch(cfg, b: int = 2, s: int = 16, seed: int = 0):
    """A seeded numpy batch in the reference test's layout: frame embeds and
    decoder tokens for encoder-decoders, 8 frontend embeds before the
    tokens for vision archs, tokens otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frontend_embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size, (b, s // 2)).astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.modality == "vision":
        out["tokens"] = out["tokens"][:, : s - 8]
        out["frontend_embeds"] = rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32)
    return out


def to_jax(arrays: dict, cfg) -> dict:
    return {k: jnp.asarray(v, cfg.dtype if v.dtype == np.float32 else jnp.int32)
            for k, v in arrays.items()}


def to_torch(arrays: dict, cfg) -> dict:
    return {k: torch.from_numpy(v).to(cfg.dtype if v.dtype == np.float32 else torch.int32)
            for k, v in arrays.items()}


@functools.lru_cache(maxsize=None)
def j_forward(jc):
    """The reference's forward (``encdec_forward`` for encoder-decoders),
    jitted once per config, without remat."""
    if jc.is_encoder_decoder:
        return jax.jit(functools.partial(jed.encdec_forward, cfg=jc, remat=False))
    return jax.jit(functools.partial(jtfm.forward, cfg=jc, remat=False))


@functools.lru_cache(maxsize=None)
def j_decode_step(jc):
    """The reference's decode step, jitted once per config (``pos`` traced)."""
    if jc.is_encoder_decoder:
        return jax.jit(functools.partial(jed.encdec_decode_step, cfg=jc))
    return jax.jit(functools.partial(jtfm.decode_step, cfg=jc))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)
