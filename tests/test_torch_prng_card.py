"""The threefry kernel on the card (``csrc/threefry.cu``), against its plain
version and against ``jax.random``'s known answers, written here as
constants (the card's machine has no JAX).  These tests need a CUDA
device and skip without one; on the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_prng_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.threefry import threefry_cuda, threefry_plain

#: ``jax.random.bits(PRNGKey(0), (6,))`` and ``uniform(PRNGKey(42), (3,),
#: minval=-3.7, maxval=2.1)`` (JAX 0.9.0 on the CPU).
BITS0 = [4070199207, 4202968722, 1427181096, 2012915765, 2447653815, 710830403]
UNIFORM42 = ["-0x1.bb20c80000000p-1", "0x1.f14d8c0000000p-3", "-0x1.0147d00000000p-3"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("mode", ["bits", "pairs", "uniform"])
def test_threefry_kernel_equals_plain_on_the_card(card, mode):
    """Bit for bit: 300 keys, odd counts, counters across 2**32, a launch
    counted each time."""
    keys = prng.split(prng.prng_key(5, card), 300)
    for n, start in ((1, 0), (1001, 0), (46208, 2**32 - 7)):
        before = threefry_cuda.launches
        got = ops.threefry(keys, n, mode, start=start, minval=-3.7, maxval=2.1)
        want = threefry_plain(keys, n, mode, start=start, minval=-3.7, maxval=2.1)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and threefry_cuda.launches == before + 1


@pytest.mark.card
def test_threefry_kernel_gives_jax_randoms_known_answers(card):
    bits = prng.random_bits(prng.prng_key(0, card), 6).cpu().numpy().view(np.uint32)
    assert bits.tolist() == BITS0
    u = prng.uniform(prng.prng_key(42, card), 3, minval=-3.7, maxval=2.1)
    assert u.tolist() == [float.fromhex(x) for x in UNIFORM42]
