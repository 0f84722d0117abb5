"""The ingress-pack kernel's adaptive mode on the card
(``csrc/ingress_pack.cu``, ``ingress_pack_adaptive``): bit for bit its
plain twin (the adaptive Gaussian booleanize, then the plain pack), and
the engine's adaptive ``fused`` route one launch of it a call.  These
tests need a CUDA device and skip without one; on the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_ingress_card.py
"""

import numpy as np
import pytest
import torch
from _near_mean import ADAPTIVE_CASES, near_mean_images

from repro_torch.configs.convcotm import COTM_CONFIGS
from repro_torch.core.cotm import init_boundary_model
from repro_torch.core.patches import PatchSpec
from repro_torch.core.prng import prng_key
from repro_torch.kernels import ops, registry
from repro_torch.kernels.ingress import ingress_pack_adaptive_cuda, ingress_pack_adaptive_plain
from repro_torch.serve.engine import ServingEngine

GEOMETRIES = {
    "paper": PatchSpec(),
    "noisy_xor": PatchSpec(image_x=4, image_y=4, window_x=2, window_y=2),
    "stride2": PatchSpec(image_x=12, image_y=12, window_x=4, window_y=4, stride_x=2,
                         stride_y=2),
    "whole_image": PatchSpec(image_x=11, image_y=9, window_x=11, window_y=9),
    "wide": PatchSpec(image_x=48, image_y=20, window_x=36, window_y=6, stride_x=3,
                      stride_y=2),
    # P*W past the kernel's shared tile: the patch loop runs in chunks.
    "chunked": PatchSpec(image_x=64, image_y=64, window_x=10, window_y=10),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("block_size,c", ADAPTIVE_CASES)
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_adaptive_kernel_equals_its_twin_on_the_card(card, name, block_size, c):
    """B = 1, 5 and 256 images (planes, a flat image, a ramp and noise),
    at the case's c and at c = 0, where the local mean's last bit decides
    the planes' pixels; one launch each."""
    spec = GEOMETRIES[name]
    imgs = torch.from_numpy(near_mean_images(256, spec.image_y, spec.image_x,
                                             seed=block_size)).to(card)
    for b in (1, 5, 256):
        for cc in (c, 0.0):
            before = ingress_pack_adaptive_cuda.launches
            got = ops.ingress_pack_adaptive(imgs[:b], spec, block_size, cc)
            want = ingress_pack_adaptive_plain(imgs[:b], spec, block_size, cc)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, b, block_size, cc)
            assert ingress_pack_adaptive_cuda.launches == before + 1


@pytest.mark.card
def test_engine_adaptive_fused_route_launches_the_adaptive_kernel_once_a_call(card):
    """convcotm-fmnist on ``fused``: each raw request is one launch of the
    adaptive mode and one of the clause kernel, and none of the bits mode;
    the answers equal the CPU engine's (the plain composition)."""
    arch = "convcotm-fmnist"
    cfg = COTM_CONFIGS[arch]
    model = init_boundary_model(prng_key(3), cfg)
    g = torch.Generator().manual_seed(3)
    few = torch.rand(tuple(model.ta_state.shape), generator=g) < 3.0 / cfg.n_literals
    model = type(model)(ta_state=torch.where(few, 133, 123).to(torch.uint8),
                        weights=model.weights.clone())
    engines = {d: ServingEngine(max_batch=256, device=d) for d in (card, "cpu")}
    for eng in engines.values():
        eng.register(arch, model, cfg, booleanize_method="adaptive", path="fused")
    engines[card].warmup(arch)
    requests = [near_mean_images(n, 28, 28, seed=n) for n in (5, 17, 256)]
    registry.reset_launches()
    got = [engines[card].classify(arch, r) for r in requests]
    counts = registry.launch_counts()
    assert counts["ingress_pack_adaptive"] == counts["fused_infer"] == len(requests)
    assert counts["ingress_pack"] == 0
    for r, res in zip(requests, got):
        want = engines["cpu"].classify(arch, r)
        assert np.array_equal(res.predictions, want.predictions)
        assert np.array_equal(res.class_sums, want.class_sums)
    assert any(res.class_sums.any() for res in got)
