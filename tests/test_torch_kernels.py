"""Port vs reference: the two kernels of the serving path, on the CPU.

Here a CPU tensor takes each kernel's plain PyTorch version, which is held
bit for bit against the JAX oracle in ``repro.kernels.ref`` (and, in one
small case per kernel, against the Pallas kernel in interpret mode).  The
CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.patches import PatchSpec as JPatchSpec
from repro.core.patches import pack_bits as jpack
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.convert import words_from_uint32, words_to_uint32
from repro_torch.core.patches import PatchSpec
from repro_torch.kernels import _build, ops, registry
from repro_torch.kernels.fused_infer import fused_infer_cuda
from repro_torch.kernels.ingress import ingress_pack_cuda

# (B, P, C, 2o): the reference's kernel sweep (tests/test_kernels.py).
SHAPES = [
    (4, 361, 128, 272),   # the paper's configuration
    (1, 9, 16, 16),       # noisy-XOR scale
    (3, 50, 70, 100),     # ragged everything
    (8, 64, 256, 512),    # larger clause pool
    (2, 361, 1000, 272),  # Table III clause count
]

INGRESS_GEOMETRIES = {
    "paper": dict(image_x=28, image_y=28, window_x=10, window_y=10),
    "noisy_xor": dict(image_x=4, image_y=4, window_x=2, window_y=2),
    "stride2": dict(image_x=12, image_y=12, window_x=4, window_y=4, stride_x=2, stride_y=2),
    "whole_image": dict(image_x=11, image_y=9, window_x=11, window_y=9),
}


def _fused_inputs(b, p, c, nlit, density, seed):
    """Packed literals, packed include, nonempty, weights as numpy, from a seed."""
    rng = np.random.default_rng(seed)
    lits = (rng.random((b, p, nlit)) > 0.5).astype(np.uint8)
    inc = (rng.random((c, nlit)) > density).astype(np.uint8)
    inc[0] = 0                                          # one empty clause
    ne = inc.any(axis=1)
    w = rng.integers(-127, 128, (10, c)).astype(np.int32)
    return (np.asarray(jpack(jnp.asarray(lits))), np.asarray(jpack(jnp.asarray(inc))), ne, w)


def _port(lp, ip, ne, w):
    return (words_from_uint32(lp), words_from_uint32(ip), torch.from_numpy(ne),
            torch.from_numpy(w))


@pytest.mark.parametrize("csrf", [True, False])
@pytest.mark.parametrize("b,p,c,nlit", SHAPES)
def test_fused_infer_plain_matches_oracle(b, p, c, nlit, csrf):
    lp, ip, ne, w = _fused_inputs(b, p, c, nlit, density=0.93, seed=b * 100 + c)
    want = ref.fused_infer_ref(jnp.asarray(lp), jnp.asarray(ip), jnp.asarray(ne), jnp.asarray(w))
    got = ops.fused_infer(*_port(lp, ip, ne, w), csrf=csrf)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("density", [0.0, 1.0])
def test_fused_infer_density_extremes(density):
    """0.0: every literal included (no clause fires); 1.0: every clause
    empty (all class sums 0)."""
    lp, ip, ne, w = _fused_inputs(2, 30, 64, 128, density=density, seed=7)
    want = ref.fused_infer_ref(jnp.asarray(lp), jnp.asarray(ip), jnp.asarray(ne), jnp.asarray(w))
    got = ops.fused_infer(*_port(lp, ip, ne, w))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if density == 1.0:
        assert not got.any()


def test_fused_infer_plain_matches_interpreted_pallas():
    lp, ip, ne, w = _fused_inputs(3, 20, 40, 100, density=0.9, seed=5)
    want = jops.fused_infer(jnp.asarray(lp), jnp.asarray(ip), jnp.asarray(ne),
                            jnp.asarray(w), backend="interpret")
    np.testing.assert_array_equal(np.asarray(want), ops.fused_infer(*_port(lp, ip, ne, w)).numpy())


@pytest.mark.parametrize("name", sorted(INGRESS_GEOMETRIES))
def test_ingress_pack_plain_matches_oracle(name):
    kw = INGRESS_GEOMETRIES[name]
    js, ts = JPatchSpec(**kw), PatchSpec(**kw)
    imgs = (np.random.default_rng(3).random((5, ts.image_y, ts.image_x)) > 0.6).astype(np.uint8)
    want = ref.ingress_pack_ref(jnp.asarray(imgs), js)
    got = ops.ingress_pack(torch.from_numpy(imgs), ts)
    assert got.dtype == torch.int32 and got.shape == (5, ts.n_patches, ts.n_words)
    np.testing.assert_array_equal(np.asarray(want), words_to_uint32(got))


def test_ingress_pack_plain_matches_interpreted_pallas():
    kw = INGRESS_GEOMETRIES["stride2"]
    imgs = (np.random.default_rng(4).random((3, 12, 12)) > 0.6).astype(np.uint8)
    want = jops.ingress_pack(jnp.asarray(imgs), JPatchSpec(**kw), backend="interpret")
    got = ops.ingress_pack(torch.from_numpy(imgs), PatchSpec(**kw))
    np.testing.assert_array_equal(np.asarray(want), words_to_uint32(got))


def test_fused_infer_from_images_chains_both_kernels():
    spec = PatchSpec(**INGRESS_GEOMETRIES["stride2"])
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy((rng.random((4, 12, 12)) > 0.5).astype(np.uint8))
    _, ip, ne, w = _fused_inputs(1, 1, 24, spec.n_literals, density=0.95, seed=9)
    args = (words_from_uint32(ip), torch.from_numpy(ne), torch.from_numpy(w))
    want = ops.fused_infer(ops.ingress_pack(imgs, spec), *args)
    torch.testing.assert_close(ops.fused_infer_from_images(imgs, spec, *args), want,
                               rtol=0, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never quietly take the
    plain version."""
    spec = PatchSpec(**INGRESS_GEOMETRIES["noisy_xor"])
    imgs = torch.zeros((2, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        ingress_pack_cuda(imgs, spec)
    lp, ip, ne, w = _port(*_fused_inputs(1, 9, 16, 16, density=0.5, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        fused_infer_cuda(lp, ip, ne, w)
    with pytest.raises(ValueError, match="backend"):
        ops.fused_infer(lp, ip, ne, w, backend="triton")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """With no toolkit the build raises; there is no silent plain fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_registry_names_every_kernel():
    assert set(registry.KERNELS) == {"ingress_pack", "fused_infer"}
    for k in registry.KERNELS.values():
        assert hasattr(ref, k.jax_oracle)
        assert k.cuda.launches >= 0 and callable(k.plain)
        assert (_build.CSRC / f"{k.name}.cu").exists()
    registry.reset_launches()
    assert registry.launch_counts() == {"ingress_pack": 0, "fused_infer": 0}
