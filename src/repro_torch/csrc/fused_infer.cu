// Fused clause evaluation + class sums, for Hopper (sm_90a): the dense
// clause pool and the active (sparse) clause pool.
//
// Replaces two TPU kernels of src/repro/kernels/fused_infer.py:
//   * fused_infer_pallas (body _kernel): a clause fires on a patch iff
//     include & ~lit == 0 on every word; it fires for the image iff it
//     fires on at least one patch (sequential OR) and is nonempty;
//   * fused_infer_sparse_pallas (body _sparse_kernel): the same over the
//     active clauses only, from exclude words (~include, pad bits set): a
//     clause fires on a patch iff ~(lit | exclude) == 0 on every word.
//     There is no nonempty operand; synthetic pad rows (all-ones exclude,
//     zero weight column) fire everywhere and add nothing.
// Class sums are sum_c w[m][c] * fired[c] in int32.
//
// Bound on this card: bytes (clause_tile.cuh gives the numbers).  The
// packed literals are the only large input (P*W words per image, 12,996 B
// at the paper's geometry), and the operation floor is one test per word
// the data needs, which at B=256 stays below the byte time.
//
// Design, against the TPU kernel's sequential grid: the Pallas grid runs
// in order and carries the OR register across patch chunks and the class
// sums across clause blocks.  CUDA blocks run in parallel and in no
// order, so here one block owns one image and one tile of up to 128
// clauses and runs the patch loop itself (clause_tile.cuh: the image's
// literals staged once with cp.async, lanes on patches, each warp on an
// equal share of the live clauses, CSRF per clause), and clause tiles
// combine their partial class sums with int32 atomicAdd, exact in any
// order; the caller zeroes the output.  The epilogue reads the tile's
// fired flags from shared memory: warp j sums classes j, j + warps, ...,
// one shuffle reduction and one atomicAdd each.

#include "clause_tile.cuh"

namespace {

// model: include words (dense) or exclude words (sparse), [C, W];
// nonempty: [C] on the dense path, null on the sparse one.
template <bool kSparse>
__global__ void __launch_bounds__(32 * clause_tile::kMaxWarps, 2)
fused_infer_kernel(const int32_t* __restrict__ lit,      // [B, P, W]
                   const int32_t* __restrict__ model,    // [C, W]
                   const uint8_t* __restrict__ nonempty, // [C] or null
                   const int8_t* __restrict__ weights,   // [M, C]
                   int32_t* __restrict__ out,            // [B, M]
                   int P, int C, int W, int M, int block_c, int chunk,
                   int csrf) {
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * block_c;
  const int* fired = clause_tile::tile_fires<kSparse>(
      lit + (size_t)b * P * W, model, nonempty, P, C, W, c0, block_c, chunk, csrf);

  // Class sums of this tile: warp j reduces classes m = j, j + warps, ...
  // and adds its partial sum to out[b][m].
  const int rows = min(block_c, C - c0);
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int m = threadIdx.x >> 5; m < M; m += nwarps) {
    const int8_t* wm = weights + (size_t)m * C + c0;
    int v = 0;
    for (int k = lane; k < rows; k += 32) v += fired[k] ? (int)wm[k] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0) atomicAdd(out + (size_t)b * M + m, v);
  }
}

template <bool kSparse>
int launch(const void* lit, const void* model, const void* nonempty, const void* weights,
           void* out, int B, int P, int C, int W, int M, int block_c, int csrf,
           void* stream) {
  int smem = 0;
  const int chunk = clause_tile::plan_chunk(P, W, block_c, &smem);
  cudaError_t e = clause_tile::allow_smem(fused_infer_kernel<kSparse>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (C + block_c - 1) / block_c);
  fused_infer_kernel<kSparse><<<grid, 32 * clause_tile::warps_for(block_c), smem,
                                (cudaStream_t)stream>>>(
      (const int32_t*)lit, (const int32_t*)model, (const uint8_t*)nonempty,
      (const int8_t*)weights, (int32_t*)out, P, C, W, M, block_c, chunk, csrf);
  return (int)cudaGetLastError();
}

}  // namespace

// lit: int32 [B, P, W]; inc: int32 [C, W]; nonempty: uint8 [C];
// weights: int8 [M, C]; out: int32 [B, M], zero on entry.
// block_c: clauses per tile, a multiple of 32 and at most 256.
// Returns cudaGetLastError().
extern "C" int fused_infer(const void* lit, const void* inc, const void* nonempty,
                           const void* weights, void* out, int B, int P, int C, int W,
                           int M, int block_c, int csrf, void* stream) {
  return launch<false>(lit, inc, nonempty, weights, out, B, P, C, W, M, block_c, csrf,
                       stream);
}

// The active clause pool: exc: int32 [C_a, W] exclude words;
// weights: int8 [M, C_a]; out: int32 [B, M], zero on entry.  C_a >= 1.
extern "C" int fused_infer_sparse(const void* lit, const void* exc, const void* weights,
                                  void* out, int B, int P, int C, int W, int M,
                                  int block_c, int csrf, void* stream) {
  return launch<true>(lit, exc, nullptr, weights, out, B, P, C, W, M, block_c, csrf,
                      stream);
}
