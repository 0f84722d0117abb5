"""Port vs reference: the LM substrate's configs and its forward roofline
model, held exactly.

All ten of the reference's ``ARCHS`` and their ``reduced_config`` agree
field by field (the dtype by name: ``jnp.bfloat16`` against
``torch.bfloat16``; the fields the port adds sit at their defaults, under
which it computes what the reference does), as do
``param_count``, ``active_param_count``, ``SHAPES``, ``applicable_shapes``
and ``TrainConfig``.  The port's declaration trees count the reference's
parameters and bytes, and its ``flops_estimate``, ``hbm_bytes_estimate``
and ``model_flops`` give the reference's numbers for every (arch, shape).
The port's registry holds the reference's archs and its own
(``PORT_ONLY_ARCHS``, held in ``test_torch_mla_moe.py``).
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import ShapeConfig as JShape
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import applicable_shapes as j_applicable
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced_config as j_reduced
from repro.launch import specs as JS
from repro.models.base import param_bytes as j_param_bytes
from repro.models.base import param_count as j_param_count
from repro.roofline.analysis import model_flops as j_model_flops
from repro.roofline.flops import flops_estimate as j_flops
from repro.roofline.flops import hbm_bytes_estimate as j_hbm
from repro_torch import ARCHS, get_config
from repro_torch.configs import (
    PORT_ONLY_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    applicable_shapes,
    paired_archs,
    reduced_config,
)
from repro_torch.launch.specs import abstract_model, model_decls
from repro_torch.models.base import param_bytes, param_count
from repro_torch.roofline import flops_estimate, hbm_bytes_estimate, model_flops

ARCH_NAMES = sorted(J_ARCHS)


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    dt = out.pop("dtype")
    out["dtype"] = jnp.dtype(dt).name if not isinstance(dt, torch.dtype) else str(dt)[6:]
    return out


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ModelConfig)}


def _as_reference(cfg, ref) -> dict:
    """The port config's fields that the reference's config has.  The
    fields the port adds (latent attention, leading dense layers, the
    router's kind, the shared expert's gate) must sit at their defaults."""
    mine, theirs = _fields(cfg), _fields(ref)
    extra = {k: v for k, v in mine.items() if k not in theirs}
    assert extra == {k: _DEFAULTS[k] for k in extra}
    return {k: mine[k] for k in theirs}


def test_registry_lists_the_same_archs():
    assert paired_archs() == j_list_archs() == ARCH_NAMES
    assert sorted(ARCHS) == sorted(ARCH_NAMES + list(PORT_ONLY_ARCHS))
    assert not set(PORT_ONLY_ARCHS) & set(J_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_config_equals_reference_field_by_field(arch):
    assert _as_reference(get_config(arch), J_ARCHS[arch]) == _fields(J_ARCHS[arch])
    assert get_config(arch).dtype is torch.bfloat16


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_reduced_config_equals_reference_field_by_field(arch):
    assert _as_reference(reduced_config(ARCHS[arch]), j_reduced(J_ARCHS[arch])) == _fields(
        j_reduced(J_ARCHS[arch]))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_equal_reference(arch):
    for t, j in ((ARCHS[arch], J_ARCHS[arch]),
                 (reduced_config(ARCHS[arch]), j_reduced(J_ARCHS[arch]))):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert [t.pattern_for_layer(i) for i in range(t.n_layers)] == [
            j.pattern_for_layer(i) for i in range(j.n_layers)]


def test_shapes_train_config_and_applicable_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert [s.is_decode for s in SHAPES.values()] == [s.is_decode for s in J_SHAPES.values()]
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
    for arch in ARCH_NAMES:
        assert applicable_shapes(ARCHS[arch]) == j_applicable(J_ARCHS[arch])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_declared_parameters_count_the_references(arch):
    """The port's per-layer declarations count what the reference's
    stacked ones count, in parameters and bytes, and the meta-device model
    holds that many parameters."""
    t, j = reduced_config(ARCHS[arch]), j_reduced(J_ARCHS[arch])
    assert param_count(model_decls(t)) == j_param_count(JS.model_decls(j))
    assert param_bytes(model_decls(t)) == j_param_bytes(JS.model_decls(j))
    assert sum(p.numel() for p in abstract_model(t).parameters()) == j_param_count(
        JS.model_decls(j))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_flops_and_bytes_equal_reference_for_every_shape(arch):
    t, j = ARCHS[arch], J_ARCHS[arch]
    for name in J_SHAPES:
        ts, js = SHAPES[name], J_SHAPES[name]
        assert flops_estimate(t, ts) == j_flops(j, js)
        for chips, mb in ((1, 1), (4, 1), (256, 4)):
            assert hbm_bytes_estimate(t, ts, chips, mb) == j_hbm(j, js, chips, mb)
    # The reduced configs and a small decode cell too (window shorter than
    # the cache, one cycle and a tail).
    rt, rj = reduced_config(t), j_reduced(j)
    for args in (("decode", 48, 4, "decode"), ("prefill", 2048, 1, "prefill"),
                 ("train", 64, 2, "train")):
        assert flops_estimate(rt, ShapeConfig(*args)) == j_flops(rj, JShape(*args))
        assert hbm_bytes_estimate(rt, ShapeConfig(*args), 1) == j_hbm(rj, JShape(*args), 1)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_reference(kind):
    for arch in ARCH_NAMES:
        c = ARCHS[arch]
        args = (c.param_count(), c.active_param_count(), 4096, kind)
        assert model_flops(*args) == j_model_flops(*args)
