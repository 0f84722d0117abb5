"""Port vs reference: the six kernels of the serving paths, on the CPU.

Here a CPU tensor takes each kernel's plain PyTorch version, which is held
bit for bit against the JAX oracle in ``repro.kernels.ref`` (and, in one
small case per kernel, against the Pallas kernel in interpret mode).  The
CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.booleanize import adaptive_gaussian_booleanize as j_adaptive
from repro.core.patches import PatchSpec as JPatchSpec
from repro.core.patches import pack_bits as jpack
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.convert import words_from_uint32, words_to_uint32
from repro_torch.core.patches import PatchSpec
from repro_torch.kernels import (
    _build, class_sum, clause_eval, fused_infer, gqa_decode, ingress, kda, ops, registry,
)
from repro_torch.kernels.class_sum import class_sum_cuda
from repro_torch.kernels.clause_eval import clause_eval_cuda, clause_eval_sparse_cuda
from repro_torch.kernels.fused_infer import fused_infer_cuda, fused_infer_sparse_cuda
from repro_torch.kernels.ingress import ingress_pack_adaptive_cuda, ingress_pack_cuda

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


@pytest.mark.parametrize("name", sorted(INGRESS_GEOMETRIES))
def test_ingress_pack_adaptive_plain_matches_oracle(name):
    """The adaptive mode's plain twin: raw pixels through the reference's
    adaptive booleanize and its ``ingress_pack_ref`` give the same words."""
    kw = INGRESS_GEOMETRIES[name]
    js, ts = JPatchSpec(**kw), PatchSpec(**kw)
    imgs = np.random.default_rng(7).integers(0, 256, (4, ts.image_y, ts.image_x),
                                             dtype=np.uint8)
    for block_size, c in ((11, 2.0), (3, 0.5)):
        want = ref.ingress_pack_ref(j_adaptive(jnp.asarray(imgs), block_size, c), js)
        got = ops.ingress_pack_adaptive(torch.from_numpy(imgs), ts, block_size, c)
        assert got.dtype == torch.int32 and got.shape == (4, ts.n_patches, ts.n_words)
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


# (B, C, M) of the class sums: the paper's pool, ragged C (70 misaligns
# every fired row, 88 is the few40 active pool), the envelope (C=1024,
# M=64) at two batches, Table III's 1000 clauses, a B tail past a 16-image
# tile, and the smallest case.
CLASS_SUM_SHAPES = [(256, 128, 10), (3, 70, 10), (2, 1024, 64), (1, 1, 1), (256, 1000, 10),
                    (256, 1024, 64), (17, 88, 10), (300, 128, 10)]


@pytest.mark.parametrize("b,c,m", CLASS_SUM_SHAPES)
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


# csrc/class_sum.cu's tiling: images and classes per block, warps (the
# clause-axis split), clauses per staged chunk, stages, shared row stride.
CS_IMAGES, CS_CLASSES, CS_WARPS = 16, 16, 8
CS_CHUNK = 32 * CS_WARPS
CS_STAGES = 1024 // CS_CHUNK
CS_STRIDE = CS_CHUNK + 16


def _copy_width(c: int) -> int:
    """The launch's cp.async width for 16-byte aligned bases: the widest of
    16, 8 and 4 bytes that divides C, else bytewise."""
    return next((v for v in (16, 8, 4) if c % v == 0), 1)


def _ldmatrix_x4(stage: np.ndarray, addr: np.ndarray) -> np.ndarray:
    """``ldmatrix.m8n8.x4.b16`` on a flat byte array: lane l gives the row
    address ``addr[l]`` of row l % 8 of matrix l // 8 and receives, as
    register j, bytes 4 (l % 4) .. +3 of row l // 4 of matrix j.  Returns
    uint8 ``[32 lanes, 4 registers, 4 bytes]``."""
    assert (addr % 16 == 0).all()
    lane = np.arange(32)
    rows = addr[8 * np.arange(4)[None, :] + (lane >> 2)[:, None]]           # [32, 4]
    return stage[rows[..., None] + 4 * (lane & 3)[:, None, None] + np.arange(4)]


def _mma_m16n8k32(acc: np.ndarray, a: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> None:
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` from the PTX fragment
    layouts, g = lane // 4, q = lane % 4: A register i holds row g (+8 for
    odd i), bytes 4q .. 4q+3 (+16 for i >= 2); B registers 0/1 hold column
    g, rows 4q .. 4q+3 (+16); accumulator i holds row g (+8 for i >= 2),
    column 2q + (i % 2)."""
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    a8, bb = a.view(np.int8).astype(np.int64), np.stack([b0, b1], 1).view(np.int8)
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        A[(g + 8 * (i & 1))[:, None], (4 * q + 16 * (i >> 1))[:, None] + np.arange(4)] = a8[:, i]
    for i in range(2):
        B[(4 * q + 16 * i)[:, None] + np.arange(4), g[:, None]] = bb[:, i]
    D = A @ B
    for i in range(4):
        acc[:, i] += D[g + 8 * (i >> 1), 2 * q + (i & 1)]


def _class_sum_tiles(fired: np.ndarray, w: np.ndarray, vec=None) -> np.ndarray:
    """numpy model of ``csrc/class_sum.cu``: fired 0/1 uint8 ``[B, C]``,
    int8 weights ``[M, C]`` -> int32 ``[B, M]``.  Each block (16 images x
    16 classes) stages chunks of 256 clauses in ``vec``-byte copies (fired
    rows, then weight rows; bytes past C, images past B and classes past M
    zero-filled); warp w takes the w-th 32-byte k-step of each chunk,
    loads its fragments with ldmatrix from the padded rows and runs one
    mma per n8 tile; the warps' partial tiles are added and only b < B,
    m < M are written, each exactly once.  Stage bytes the copies do not
    write hold garbage, so a read past the chunk shows."""
    b, c = fired.shape
    m = w.shape[0]
    vec = vec or _copy_width(c)
    assert c % vec == 0 and CS_CHUNK % vec == 0
    rows, per_row = CS_IMAGES + CS_CLASSES, CS_CHUNK // vec
    tiles = CS_CLASSES // 8
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    src = (fired.astype(np.uint8), w.astype(np.int8).view(np.uint8))
    out = np.zeros((b, m), np.int64)
    written = np.zeros((b, m), np.int64)
    rng = np.random.default_rng(0)
    for b0 in range(0, b, CS_IMAGES):
        for m0 in range(0, m, CS_CLASSES):
            acc = np.zeros((CS_WARPS, tiles, 32, 4), np.int64)
            for ch in range(-(-c // CS_CHUNK)):          # stage ch % CS_STAGES: no state kept
                stage = rng.integers(0, 256, (rows, CS_STRIDE), dtype=np.uint8)
                copies = np.zeros((rows, CS_STRIDE), np.int64)
                i = np.arange(rows * per_row)
                r, k = i // per_row, (i % per_row) * vec
                cc = ch * CS_CHUNK + k
                image = r < CS_IMAGES
                idx = np.where(image, b0 + r, m0 + r - CS_IMAGES)
                valid = (cc < c) & (idx < np.where(image, b, m))
                for j in range(vec):
                    byte = np.zeros(len(i), np.uint8)
                    for which in (0, 1):
                        sel = valid & (image == (which == 0))
                        byte[sel] = src[which][idx[sel], cc[sel] + j]
                    stage[r, k + j] = byte
                    copies[r, k + j] += 1
                assert (copies[:, :CS_CHUNK] == 1).all() and not copies[:, CS_CHUNK:].any()
                flat = stage.reshape(-1)
                for warp in range(CS_WARPS):
                    if ch * CS_CHUNK + 32 * warp >= c:   # the k-step lies past C
                        continue
                    a_off = ((lane & 7) + (lane & 8)) * CS_STRIDE + (lane >> 4) * 16 + 32 * warp
                    b_off = ((CS_IMAGES + (lane & 7) + ((lane >> 4) << 3)) * CS_STRIDE
                             + ((lane >> 3) & 1) * 16 + 32 * warp)
                    a = _ldmatrix_x4(flat, a_off)
                    for t in range(0, tiles, 2):
                        bf = _ldmatrix_x4(flat, b_off + 8 * t * CS_STRIDE)
                        _mma_m16n8k32(acc[warp, t], a, bf[:, 0], bf[:, 1])
                        _mma_m16n8k32(acc[warp, t + 1], a, bf[:, 2], bf[:, 3])
            part = np.zeros((CS_WARPS, CS_IMAGES, CS_CLASSES), np.int64)
            for t in range(tiles):
                for i in range(4):
                    part[:, (g + 8 * (i >> 1)), 8 * t + 2 * q + (i & 1)] = acc[:, t, :, i]
            v = part.sum(0)
            nb, nm = min(CS_IMAGES, b - b0), min(CS_CLASSES, m - m0)
            out[b0 : b0 + nb, m0 : m0 + nm] = v[:nb, :nm]
            written[b0 : b0 + nb, m0 : m0 + nm] += 1
    assert (written == 1).all()
    return out.astype(np.int32)


def _class_sum_inputs(b, c, m, kind):
    """Seeded random bits and weights over the int8 range, or one-hot fired
    rows against weights ``((m*C + c) mod 255) - 127``, which differ in
    every (class, clause): each sum is then one weight, so a swapped row,
    class or clause of a fragment shows."""
    if kind == "one-hot":
        fired = np.zeros((b, c), np.uint8)
        fired[np.arange(b), (np.arange(b) * 7) % c] = 1
        return fired, (np.arange(m * c).reshape(m, c) % 255 - 127).astype(np.int8)
    rng = np.random.default_rng(b * 7 + c + m)
    return ((rng.random((b, c)) > 0.5).astype(np.uint8),
            rng.integers(-128, 128, (m, c)).astype(np.int8))


@pytest.mark.parametrize("kind", ["random", "one-hot"])
@pytest.mark.parametrize("b,c,m", CLASS_SUM_SHAPES + [(40, 3004, 20)])
def test_class_sum_tile_model_matches_plain_and_oracle(b, c, m, kind):
    """The CUDA class-sum kernel's tiling (K chunks with zero fill, n8 tiles
    with padded classes, 16-image tiles with the B tail, the K split across
    warps), modelled in numpy, against the plain version and the oracle;
    C = 3004 refills the stage ring, in 4-byte copies."""
    fired, w = _class_sum_inputs(b, c, m, kind)
    got = _class_sum_tiles(fired, w)
    plain = ops.class_sum(torch.from_numpy(fired), torch.from_numpy(w))
    np.testing.assert_array_equal(got, plain.numpy())
    want = np.asarray(ref.class_sum_ref(jnp.asarray(fired), jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)


def test_class_sum_tile_model_matches_interpreted_pallas():
    """The model on a ragged case (B tail, C = 88 not a multiple of 16, M
    padded to 16), with every copy width the launch can pick for it,
    against the Pallas kernel in interpret mode."""
    fired, w = _class_sum_inputs(17, 88, 10, "random")
    want = np.asarray(jops.class_sum(jnp.asarray(fired), jnp.asarray(w.astype(np.int32)),
                                     backend="interpret"))
    for vec in (8, 4, 1):
        np.testing.assert_array_equal(_class_sum_tiles(fired, w, vec), want)


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


def test_adaptive_wrapper_refuses_what_its_launch_cannot_take():
    """The adaptive mode's wrapper raises, each with its message, on a
    window past the taps its launch holds (or an even one), on images that
    are not uint8, and on a CPU tensor; it never takes the plain twin."""
    spec = PatchSpec(**INGRESS_GEOMETRIES["paper"])
    raw = torch.zeros((2, 28, 28), dtype=torch.uint8)
    for bad in (ingress.MAX_TAPS + 2, 12):
        with pytest.raises(ValueError, match=f"odd and at most {ingress.MAX_TAPS}"):
            ingress_pack_adaptive_cuda(raw, spec, bad, 2.0)
    with pytest.raises(TypeError, match="uint8"):
        ingress_pack_adaptive_cuda(raw.float(), spec, 11, 2.0)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ingress_pack_adaptive_cuda(raw, spec, 11, 2.0)
    with pytest.raises(ValueError, match="backend"):
        ops.ingress_pack_adaptive(raw, spec, backend="triton")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """With no toolkit the build raises; there is no silent plain fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_registry_names_every_kernel():
    """The six TPU kernels' counterparts, each naming its ``kernels/ref.py``
    oracle and the Pallas kernel it replaces, the ingress kernel's adaptive
    mode (the same source and Pallas kernel), and the port-only threefry
    kernel, whose oracle is ``jax.random``'s and which replaces no Pallas
    kernel (XLA lowers the reference's generator)."""
    names = {"ingress_pack", "ingress_pack_adaptive", "fused_infer", "fused_infer_sparse",
             "clause_eval", "clause_eval_sparse", "class_sum", "threefry"}
    assert set(registry.KERNELS) == names
    repo = _build.CSRC.parents[2]
    for k in registry.KERNELS.values():
        assert k.cuda.launches >= 0 and callable(k.plain)
        assert (repo / k.source).exists() and k.source.endswith(".cu")
        assert (repo / k.source).stem in _build.SOURCES
        if k.name == "threefry":
            assert k.jax_oracle == "jax.random.bits" and callable(jax.random.bits)
            assert k.replaces.startswith("(none")
            continue
        assert hasattr(ref, k.jax_oracle)
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


@pytest.mark.parametrize("geometry", [
    dict(image_x=28, image_y=28, window_x=10, window_y=10),
    dict(image_x=64, image_y=64, window_x=10, window_y=10),
    dict(image_x=48, image_y=20, window_x=36, window_y=6, stride_x=3, stride_y=2),
])
def test_ingress_shared_bytes_add_the_adaptive_modes_two_float_planes(geometry):
    """The adaptive mode's launch adds two float32 Y x X planes (the pixels
    and the Gaussian's Y pass) to the bits mode's rows and tile, as the C
    entry point sizes it; 6,272 bytes at the paper's geometry."""
    spec = PatchSpec(**geometry)
    planes = 2 * 4 * spec.image_y * spec.image_x
    assert ingress.shared_bytes(spec, adaptive=True) == ingress.shared_bytes(spec) + planes
    assert ingress.shared_bytes(spec, adaptive=True) <= ingress.MAX_SHARED_BYTES
    if spec.image_x == spec.image_y == 28:
        assert planes == 6272


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
    (ingress, ("ingress_pack_adaptive",), "ingress_pack"),
    (fused_infer, ("fused_infer",), "fused_infer"),
    (fused_infer, ("fused_infer_sparse",), "fused_infer"),
    (clause_eval, ("clause_eval",), "clause_eval"),
    (clause_eval, ("clause_eval_sparse",), "clause_eval"),
    (class_sum, (), "class_sum"),
    (kda, (), "kda_decode"),
    (gqa_decode, (), "gqa_decode"),
    (gqa_decode, ("gqa_decode_scratch",), "gqa_decode"),
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
    _other_build(tmp_path / "parent", _build.SOURCES)
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


def _other_build(directory, names):
    """Stand-in files for another build's libraries of ``names``."""
    directory.mkdir(parents=True, exist_ok=True)
    for n in names:
        (directory / f"lib{n}.so").write_bytes(b"")


def test_libraries_from_keeps_this_trees_library_where_the_other_build_has_none(
        monkeypatch, tmp_path):
    """A source the other build lacks (an earlier commit without the
    threefry kernel) keeps this tree's library inside the block."""
    _other_build(tmp_path / "parent", [n for n in _build.SOURCES if n != "threefry"])
    monkeypatch.setattr(_build, "_open", _FakeLib)
    monkeypatch.setattr(_build, "_loaded",
                        {n: _FakeLib(f"tree/lib{n}.so") for n in _build.SOURCES})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "_foreign", {})
    with _build.libraries_from(tmp_path / "parent") as libs:
        assert "threefry" not in libs and "class_sum" in libs
        assert _build.library("class_sum").path == str(tmp_path / "parent" / "libclass_sum.so")
        monkeypatch.setattr(_build, "build_all",
                            lambda names: {n: f"tree/lib{n}.so" for n in names})
        assert _build.library("threefry").path == "tree/libthreefry.so"


def test_libraries_from_raises_where_the_other_builds_library_fails_to_load(
        monkeypatch, tmp_path):
    """A library the other build has but that does not load (a bad build, a
    missing symbol) raises: its kernels' times are never this tree's."""
    def fake_open(path):
        if "class_sum" in str(path):
            raise OSError(f"{path}: undefined symbol")
        return _FakeLib(path)

    _other_build(tmp_path / "parent", _build.SOURCES)
    monkeypatch.setattr(_build, "_open", fake_open)
    monkeypatch.setattr(_build, "_foreign", {})
    with pytest.raises(OSError, match="undefined symbol"):
        with _build.libraries_from(tmp_path / "parent"):
            pass
    assert _build._foreign == {}
