"""The plain reference against the port's plain CPU path, the frozen
word-test count against a brute-force loop, and the controls at a size a
test run holds."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import program, reference
from harness.cell import ROOT, rngs
from harness.glyphs import glyph_pool
from harness.model_state import make_model

CONFIGS = ("convcotm-mnist", "convcotm-fmnist")


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def _inputs(name, seed=7, n=24):
    cfg = _cfg(name)
    r = rngs(seed)
    pool = glyph_pool(r[1], n)
    ta, w = make_model(r[2], cfg, pool)
    return cfg, pool, ta, w


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_ports_plain_path(name):
    cfg, pool, ta, w = _inputs(name)
    engine = program.build_engine(cfg, name, ta, w, torch.device("cpu"))
    got = engine.classify(name, pool)
    sums, preds, _ = reference.classify(pool, cfg, ta, w)
    np.testing.assert_array_equal(got.class_sums, sums)
    np.testing.assert_array_equal(got.predictions, preds)
    assert len(np.unique(preds)) > 1          # the seeded model separates the glyphs


def test_adaptive_bits_equal_the_ports():
    from repro_torch.core.booleanize import adaptive_gaussian_booleanize

    cfg, pool, _, _ = _inputs("convcotm-fmnist", n=64)
    mine = reference.booleanize(pool, cfg["booleanize"])
    port = adaptive_gaussian_booleanize(torch.from_numpy(pool), 11, 2.0).numpy()
    np.testing.assert_array_equal(mine, port)


@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_model_has_the_assumed_shape(name):
    cfg, pool, ta, w = _inputs(name)
    inc = ta >= reference.TA_INCLUDE
    counts = inc.sum(axis=1)
    assert set(counts) <= set(cfg["assumed"]["literals_per_clause"])
    assert (counts > 0).all() == (cfg["assumed"]["empty_clause_share"] == 0)
    assert w.min() >= -127 and w.max() <= 127
    # One seed gives one model; another seed another.
    _, _, ta2, w2 = _inputs(name)
    np.testing.assert_array_equal(ta, ta2)
    assert not np.array_equal(ta, _inputs(name, seed=8)[2])


def _brute_word_tests(lit, inc, nonempty):
    """The count by loops, over packed words (LSB-first)."""
    n, p, nl = lit.shape
    nw = (nl + 31) // 32

    def pack(bits):
        return [int(sum(int(b) << k for k, b in enumerate(bits[32 * i : 32 * i + 32])))
                for i in range(nw)]

    incw = [pack(row) for row in inc]
    total = np.zeros(n, np.int64)
    for i in range(n):
        litw = [pack(lit[i, q]) for q in range(p)]
        for c in range(inc.shape[0]):
            if not nonempty[c]:
                continue
            for q in range(p):
                fired = True
                for k in range(nw):
                    total[i] += 1
                    if incw[c][k] & ~litw[q][k] & 0xFFFFFFFF:
                        fired = False
                        break
                if fired:
                    break
    return total


def test_word_tests_equal_a_brute_force_loop():
    cfg = {"image_y": 8, "image_x": 8, "window_y": 4, "window_x": 4, "stride_y": 1,
           "stride_x": 1, "booleanize": {"method": "threshold", "threshold": 75}}
    rng = np.random.default_rng(3)
    images = (rng.random((5, 8, 8)) < 0.4).astype(np.uint8) * 255
    lit = reference.literals(reference.booleanize(images, cfg["booleanize"]), cfg)
    assert lit.shape[-1] == 48 and reference.n_words(cfg) == 2
    c = 12
    include = np.zeros((c, 48), bool)
    for j in range(c - 1):          # clause c - 1 stays empty
        take = rng.choice(48, size=int(rng.integers(1, 6)), replace=False)
        include[j, take] = True
    include[0, :] = False
    include[0, [1, 40]] = True      # violations in either word
    ta = np.where(include, 200, 10).astype(np.uint8)
    w = rng.integers(-127, 128, (3, c))
    _, _, tests = reference.classify(images, cfg, ta, w, want_word_tests=True)
    np.testing.assert_array_equal(tests, _brute_word_tests(lit, include, include.any(1)))


@pytest.mark.parametrize("name", CONFIGS)
def test_int4_control_is_not_correct(name):
    cfg, pool, ta, w = _inputs(name, n=32)
    sums, preds, _ = reference.classify(pool, cfg, ta, w)
    c_sums, c_preds, _ = reference.classify(pool, cfg, ta, w, control="int4")
    bad = ((c_sums != sums).any(axis=1) | (c_preds != preds)).sum()
    assert bad > 0


def test_bf16_control_changes_the_booleanized_bits():
    cfg, pool, _, _ = _inputs("convcotm-fmnist", n=64)
    exact = reference.booleanize(pool, cfg["booleanize"])
    low = reference._bf16_adaptive(pool, 11, 2.0)
    assert (exact != low).sum() > 0


def test_reference_refuses_windows_it_does_not_sum():
    with pytest.raises(ValueError):
        reference.booleanize(np.zeros((1, 28, 28), np.uint8),
                             {"method": "adaptive", "block_size": 17, "c": 2.0})


def test_config_files_state_the_papers_sizes():
    for name in CONFIGS:
        cfg = _cfg(name)
        assert reference.n_patches(cfg) == cfg["n_patches"] == 361
        assert 2 * reference.feature_table(cfg).shape[1] == cfg["n_literals"] == 272
        assert reference.n_words(cfg) == cfg["n_words"] == 9
        assert (cfg["n_clauses"], cfg["n_classes"]) == (128, 10)
    assert Path(ROOT / "BENCHMARK.json").is_file()
