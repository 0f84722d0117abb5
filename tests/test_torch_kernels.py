"""Port vs reference: the six kernels of the serving paths, on the CPU.

Here a CPU tensor takes each kernel's plain PyTorch version, which is held
bit for bit against the JAX oracle in ``repro.kernels.ref`` (and, in one
small case per kernel, against the Pallas kernel in interpret mode).  The
CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import ctypes

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
from repro_torch.kernels import (
    _build, class_sum, clause_eval, fused_infer, ingress, ops, registry,
)
from repro_torch.kernels.class_sum import class_sum_cuda
from repro_torch.kernels.clause_eval import clause_eval_cuda, clause_eval_sparse_cuda
from repro_torch.kernels.fused_infer import fused_infer_cuda, fused_infer_sparse_cuda
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
    # Rows and window runs wider than 32 columns, W even.
    "wide": dict(image_x=48, image_y=20, window_x=36, window_y=6, stride_x=3, stride_y=2),
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


def _sparse_inputs(b, p, c, nlit, density, seed):
    """Packed literals, the active pool's exclude words (``~include``, pad
    bits set) and weight columns as numpy, as ``analyze_sparsity`` cuts them."""
    lp, ip, ne, w = _fused_inputs(b, p, c, nlit, density, seed)
    return lp, ~ip[ne], w[:, ne]


def _sparse_port(lp, ep, wa):
    return words_from_uint32(lp), words_from_uint32(ep), torch.from_numpy(wa)


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


def _run_words(imgs: np.ndarray, spec: PatchSpec) -> np.ndarray:
    """numpy model of ``csrc/ingress_pack.cu``'s word assembly: uint8 0/1
    ``[B, Y, X]`` -> uint32 ``[B, P, W]``.  Rows are packed into 32-bit
    bitmasks (plus one zero word); word w of every patch is built from the
    chunks of bit runs that overlap it: a window chunk is a funnel shift
    of two row words, a thermometer chunk a mask of low bits, and the
    second half of the literals is complemented.  The run walk depends on
    w alone, as it is warp-uniform in the kernel; patches are the vector
    axis, as lanes are."""
    b, y, x = imgs.shape
    rs = (x + 31) // 32 + 1
    cols = np.zeros((b, y, rs * 32), np.uint64)
    cols[:, :, :x] = imgs != 0
    rows = (cols.reshape(b, y, rs, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    p = np.arange(spec.n_patches)
    py, px = p // spec.bx, p % spec.bx
    n_win, n_pos_y, o = spec.n_window_features, spec.n_pos_y_bits, spec.n_features
    full = np.uint64(0xFFFFFFFF)

    def low_bits(n):
        return (np.uint64(1) << np.clip(n, 0, 32).astype(np.uint64)) - np.uint64(1)

    out = np.zeros((b, spec.n_patches, spec.n_words), np.uint64)
    for w in range(spec.n_words):
        lbase, lend = 32 * w, min(32 * w + 32, spec.n_literals)
        l = lbase
        while l < lend:
            neg = l >= o
            f = l - o if neg else l
            if f < n_win:
                wy, off = divmod(f, spec.window_x)
                n = spec.window_x - off
                col = px * spec.stride_x + off
                row = rows[:, py * spec.stride_y + wy]                  # [B, P, rs]
                lo = np.take_along_axis(row, (col // 32)[None, :, None], -1)[..., 0]
                hi = np.take_along_axis(row, (col // 32 + 1)[None, :, None], -1)[..., 0]
                v = ((hi << np.uint64(32)) | lo) >> (col % 32).astype(np.uint64) & full
            elif f < n_win + n_pos_y:
                n = n_win + n_pos_y - f
                v = np.broadcast_to(low_bits(py - (f - n_win)), (b, spec.n_patches))
            else:
                n = o - f
                v = np.broadcast_to(low_bits(px - (f - n_win - n_pos_y)), (b, spec.n_patches))
            n = min(n, lend - l)
            if neg:
                v = ~v & full
            out[..., w] |= (v & low_bits(np.array(n))) << np.uint64(l - lbase)
            l += n
    return out.astype(np.uint32)


@pytest.mark.parametrize("name", sorted(INGRESS_GEOMETRIES))
def test_ingress_run_words_match_plain_and_interpreted_pallas(name):
    """The CUDA ingress kernel's run-based word formula, modelled in numpy,
    against the plain version and the Pallas kernel in interpret mode."""
    kw = INGRESS_GEOMETRIES[name]
    spec = PatchSpec(**kw)
    imgs = (np.random.default_rng(6).random((3, spec.image_y, spec.image_x)) > 0.5)
    imgs = imgs.astype(np.uint8)
    got = _run_words(imgs, spec)
    plain = words_to_uint32(ops.ingress_pack(torch.from_numpy(imgs), spec))
    np.testing.assert_array_equal(got, plain)
    want = jops.ingress_pack(jnp.asarray(imgs), JPatchSpec(**kw), backend="interpret")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fused_infer_from_images_chains_both_kernels():
    spec = PatchSpec(**INGRESS_GEOMETRIES["stride2"])
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy((rng.random((4, 12, 12)) > 0.5).astype(np.uint8))
    _, ip, ne, w = _fused_inputs(1, 1, 24, spec.n_literals, density=0.95, seed=9)
    args = (words_from_uint32(ip), torch.from_numpy(ne), torch.from_numpy(w))
    want = ops.fused_infer(ops.ingress_pack(imgs, spec), *args)
    torch.testing.assert_close(ops.fused_infer_from_images(imgs, spec, *args), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("csrf", [True, False])
@pytest.mark.parametrize("b,p,c,nlit", SHAPES)
def test_clause_eval_plain_matches_oracle(b, p, c, nlit, csrf):
    lp, ip, ne, w = _fused_inputs(b, p, c, nlit, density=0.93, seed=b * 100 + c + 1)
    want = ref.clause_eval_ref(jnp.asarray(lp), jnp.asarray(ip), jnp.asarray(ne))
    got = ops.clause_eval(*_port(lp, ip, ne, w)[:3], csrf=csrf)
    assert got.dtype == torch.uint8 and got.shape == (b, c)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert not got[:, 0].any()                          # the empty clause


@pytest.mark.parametrize("csrf", [True, False])
@pytest.mark.parametrize("b,p,c,nlit", SHAPES)
def test_clause_eval_sparse_plain_matches_oracle(b, p, c, nlit, csrf):
    lp, ep, wa = _sparse_inputs(b, p, c, nlit, density=0.93, seed=b * 100 + c + 2)
    want = ref.clause_eval_sparse_ref(jnp.asarray(lp), jnp.asarray(ep))
    got = ops.clause_eval_sparse(*_sparse_port(lp, ep, wa)[:2], csrf=csrf)
    assert got.dtype == torch.uint8 and got.shape == (b, ep.shape[0])
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("csrf", [True, False])
@pytest.mark.parametrize("b,p,c,nlit", SHAPES)
def test_fused_infer_sparse_plain_matches_oracle(b, p, c, nlit, csrf):
    lp, ep, wa = _sparse_inputs(b, p, c, nlit, density=0.93, seed=b * 100 + c + 3)
    want = ref.sparse_infer_ref(jnp.asarray(lp), jnp.asarray(ep), jnp.asarray(wa))
    got = ops.fused_infer_sparse(*_sparse_port(lp, ep, wa), csrf=csrf)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("b,c,m", [(256, 128, 10), (3, 70, 10), (2, 1024, 64), (1, 1, 1)])
def test_class_sum_plain_matches_oracle(b, c, m):
    rng = np.random.default_rng(b + c + m)
    fired = (rng.random((b, c)) > 0.5).astype(np.uint8)
    w = rng.integers(-127, 128, (m, c)).astype(np.int32)
    want = np.asarray(ref.class_sum_ref(jnp.asarray(fired), jnp.asarray(w)))
    got = ops.class_sum(torch.from_numpy(fired), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        want, ops.class_sum(torch.from_numpy(fired.astype(bool)), torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("kernel", ["clause_eval", "clause_eval_sparse", "fused_infer_sparse",
                                    "class_sum"])
def test_new_kernels_plain_match_interpreted_pallas(kernel):
    """One small ragged case per kernel against the Pallas kernel itself."""
    lp, ip, ne, w = _fused_inputs(3, 20, 40, 100, density=0.9, seed=11)
    lp_, ep, wa = _sparse_inputs(3, 20, 40, 100, density=0.9, seed=11)
    if kernel == "clause_eval":
        want = jops.clause_eval(jnp.asarray(lp), jnp.asarray(ip), jnp.asarray(ne),
                                backend="interpret")
        got = ops.clause_eval(*_port(lp, ip, ne, w)[:3])
    elif kernel == "clause_eval_sparse":
        want = jops.clause_eval_sparse(jnp.asarray(lp_), jnp.asarray(ep), backend="interpret")
        got = ops.clause_eval_sparse(*_sparse_port(lp_, ep, wa)[:2])
    elif kernel == "fused_infer_sparse":
        want = jops.fused_infer_sparse(jnp.asarray(lp_), jnp.asarray(ep), jnp.asarray(wa),
                                       backend="interpret")
        got = ops.fused_infer_sparse(*_sparse_port(lp_, ep, wa))
    else:
        fired = np.array(ref.clause_eval_ref(jnp.asarray(lp), jnp.asarray(ip), jnp.asarray(ne)))
        want = jops.class_sum(jnp.asarray(fired), jnp.asarray(w), backend="interpret")
        got = ops.class_sum(torch.from_numpy(fired), torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_empty_active_pool_returns_before_any_kernel():
    """``C_a == 0``: uint8 ``[B, 0]`` outputs and all-zero int32 class sums,
    as the reference's short-circuits give."""
    lp, _, _, _ = _fused_inputs(3, 20, 4, 40, density=0.9, seed=12)
    ep = np.zeros((0, lp.shape[2]), np.uint32)
    wa = np.zeros((10, 0), np.int32)
    lit, exc, w = _sparse_port(lp, ep, wa)
    got = ops.clause_eval_sparse(lit, exc)
    want = jops.clause_eval_sparse(jnp.asarray(lp), jnp.asarray(ep))
    assert got.dtype == torch.uint8 and got.shape == (3, 0) == np.asarray(want).shape
    got = ops.fused_infer_sparse(lit, exc, w)
    want = jops.fused_infer_sparse(jnp.asarray(lp), jnp.asarray(ep), jnp.asarray(wa))
    assert got.dtype == torch.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert not got.any()
    got = ops.matmul_sparse_infer(torch.ones((3, 20, 40), dtype=torch.uint8),
                                  torch.zeros((0, 40), dtype=torch.uint8), w)
    assert got.shape == (3, 10) and not got.any()


@pytest.mark.parametrize("n_active", [0, 1, 37, 128])
def test_matmul_sparse_infer_matches_oracle(n_active):
    rng = np.random.default_rng(13 + n_active)
    lits = (rng.random((3, 50, 100)) > 0.4).astype(np.uint8)
    inc = (rng.random((n_active, 100)) > 0.97).astype(np.uint8)
    inc[:, 0] = 1                                       # active: nonempty
    if n_active > 1:
        inc[-1] = 0                                     # a synthetic pad row
    wa = rng.integers(-127, 128, (10, n_active)).astype(np.int32)
    if n_active > 1:
        wa[:, -1] = 0
    want = ref.matmul_sparse_infer_ref(jnp.asarray(lits), jnp.asarray(inc), jnp.asarray(wa))
    got = ops.matmul_sparse_infer(torch.from_numpy(lits), torch.from_numpy(inc),
                                  torch.from_numpy(wa))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


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
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval_cuda(lp, ip, ne)
    lit, exc, wa = _sparse_port(*_sparse_inputs(1, 9, 16, 16, density=0.5, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval_sparse_cuda(lit, exc)
    with pytest.raises(ValueError, match="CUDA"):
        fused_infer_sparse_cuda(lit, exc, wa)
    with pytest.raises(ValueError, match="CUDA"):
        class_sum_cuda(ops.clause_eval(lp, ip, ne), w)
    for call in (lambda: ops.fused_infer(lp, ip, ne, w, backend="triton"),
                 lambda: ops.clause_eval(lp, ip, ne, backend="triton"),
                 lambda: ops.clause_eval_sparse(lit, exc, backend="triton"),
                 lambda: ops.fused_infer_sparse(lit, exc, wa, backend="triton"),
                 lambda: ops.class_sum(ops.clause_eval(lp, ip, ne), w, backend="triton")):
        with pytest.raises(ValueError, match="backend"):
            call()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """With no toolkit the build raises; there is no silent plain fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_registry_names_every_kernel():
    names = {"ingress_pack", "fused_infer", "fused_infer_sparse", "clause_eval",
             "clause_eval_sparse", "class_sum"}
    assert set(registry.KERNELS) == names
    repo = _build.CSRC.parents[2]
    for k in registry.KERNELS.values():
        assert hasattr(ref, k.jax_oracle)
        assert k.cuda.launches >= 0 and callable(k.plain)
        assert (repo / k.source).exists() and k.source.endswith(".cu")
        assert (repo / k.source).stem in _build.SOURCES
        path, line = k.replaces.split()[0].split(":")
        assert k.replaces.split()[1] in (repo / path).read_text().splitlines()[int(line) - 1]
    registry.reset_launches()
    assert registry.launch_counts() == dict.fromkeys(names, 0)


@pytest.mark.parametrize("geometry, chunk", [
    (dict(image_x=28, image_y=28, window_x=10, window_y=10), 361),   # whole image
    (dict(image_x=64, image_y=64, window_x=10, window_y=10), 945),   # 12288 // 13
])
def test_ingress_shared_bytes_follow_the_kernels_chunk_rule(geometry, chunk):
    """The wrapper sizes its shared-memory check as the C entry point sizes
    the launch: row bitmasks plus a tile of whole patches."""
    spec = PatchSpec(**geometry)
    rows = spec.image_y * ((spec.image_x + 31) // 32 + 1)
    assert ingress.shared_bytes(spec) == 4 * (rows + chunk * spec.n_words)
    assert chunk * spec.n_words <= max(ingress.TILE_WORDS, spec.n_words)


class _FakeFn:
    def __init__(self, path, symbol):
        self.path, self.symbol = path, symbol


class _FakeLib:
    """Stands in for a loaded library: hands out entry points tagged with
    the path it was loaded from."""

    def __init__(self, path):
        self.path = str(path)

    def __getattr__(self, symbol):
        fn = _FakeFn(self.path, symbol)
        setattr(self, symbol, fn)
        return fn


@pytest.mark.parametrize("module, args, library", [
    (ingress, (), "ingress_pack"),
    (fused_infer, ("fused_infer",), "fused_infer"),
    (fused_infer, ("fused_infer_sparse",), "fused_infer"),
    (clause_eval, ("clause_eval",), "clause_eval"),
    (clause_eval, ("clause_eval_sparse",), "clause_eval"),
    (class_sum, (), "class_sum"),
])
def test_libraries_from_swaps_the_wrappers_entry_points(monkeypatch, tmp_path, module,
                                                        args, library):
    """Inside ``libraries_from(d)`` a wrapper's entry point comes from
    ``d/lib<name>.so``; before and after, from this tree's build."""
    monkeypatch.setattr(_build, "_open", _FakeLib)
    monkeypatch.setattr(_build, "_loaded",
                        {n: _FakeLib(f"tree/lib{n}.so") for n in _build.SOURCES})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "_foreign", {})
    symbol = args[0] if args else library
    before = module._entry(*args)
    assert (before.path, before.symbol) == (f"tree/lib{library}.so", symbol)
    assert before.restype is ctypes.c_int and before.argtypes
    for _ in range(2):                       # a second entry loads nothing anew
        with _build.libraries_from(tmp_path / "parent"):
            inside = module._entry(*args)
            assert inside.path == str(tmp_path / "parent" / f"lib{library}.so")
            assert inside.symbol == symbol and inside.argtypes == before.argtypes
        assert module._entry(*args) is before
    assert len(_build._foreign) == 1
