"""The dropless experts' CUDA path: ``torch._grouped_mm`` over the
expert-sorted rows against its plain twin at Moonlight's widths, and one
decode step of the reduced Moonlight with no host synchronisation.  They
need a CUDA device and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_mla_moe_card.py
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.prng import prng_key
from repro_torch.launch.specs import model_decls
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.base import init_params


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_grouped_swiglu_equals_its_plain_twin_at_moonlights_widths(card):
    """64 experts of 2,048 x 1,408 in bf16, 1,536 rows (256 tokens x 6),
    one expert given 200 rows and two none: each row equals its expert's
    SwiGLU computed alone (the same bf16 products; float32 accumulation in
    another order: within 2 bf16 ulps of the output's largest entry)."""
    g = torch.Generator(device=card).manual_seed(0)
    e, d, ff, rows = 64, 2048, 1408, 1536
    ids = torch.randint(0, e, (rows,), device=card, generator=g)
    ids[:200] = 3
    ids[ids == 7] = 8
    ids[ids == 9] = 10
    ends = torch.searchsorted(torch.sort(ids).values, torch.arange(e, device=card), right=True,
                              out_int32=True)
    xs = torch.randn(rows, d, device=card, generator=g).to(torch.bfloat16)
    ws = [(torch.randn(s, device=card, generator=g) / s[1] ** 0.5).to(torch.bfloat16)
          for s in ((e, d, ff), (e, d, ff), (e, ff, d))]
    got = moe_mod.grouped_swiglu(xs, ends, *ws)
    want = torch.cat([moe_mod.grouped_swiglu_plain(xs[i:i + 256], ends - i, *ws)
                      for i in range(0, rows, 256)])
    assert got.dtype == torch.bfloat16 and got.shape == (rows, d)
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2 * scale * 2 ** -8


@pytest.mark.card
def test_a_decode_step_makes_no_host_synchronisation(card):
    cfg = reduced_config(get_config("moonlight-16b-a3b"))
    params = init_params(model_decls(cfg, fan_in=True), prng_key(0, card))
    cache = tfm.init_decode_cache(8, cfg, 16, card)
    tok = torch.randint(0, cfg.vocab_size, (8, 1), device=card, dtype=torch.int32)
    tfm.decode_step(params, tok, cache, 0, cfg)          # the first call's lazy set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = tfm.decode_step(params, tok, cache, 1, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert logits.shape == (8, cfg.vocab_size) and bool(torch.isfinite(logits).all())
