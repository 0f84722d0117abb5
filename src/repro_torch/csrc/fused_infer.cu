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
// Bound on this card: bytes while work stops early, operations when it
// does not.  The packed literals are the only large input (P*W words per
// image, 12,996 B at the paper's geometry); the test is one or two bit
// operations per word, and most clauses of a real pool are violated on
// the first word, so the kernel must above all read each literal word
// once and keep every thread busy.
//
// Design, against the TPU kernel's sequential grid: the Pallas grid runs
// in order and carries the OR register across patch chunks and the class
// sums across clause blocks.  CUDA blocks run in parallel and in no
// order, so here one block owns one image and one tile of up to 128
// clauses and runs the patch loop itself (clause_tile.cuh: model words in
// shared memory, 4 patch lanes, CSRF as a __syncthreads_and vote), and
// clause tiles combine their partial class sums with int32 atomicAdd,
// exact in any order; the caller zeroes the output.  At the envelope
// (C=1024, W=256) a tile's words take 132 KB of shared memory, above the
// 48 KB default, so the launch raises the kernel's limit.

#include "clause_tile.cuh"

namespace {

using clause_tile::kLanes;

// model: include words (dense) or exclude words (sparse), [C, W];
// nonempty: [C] on the dense path, unused on the sparse one.
template <bool kSparse>
__global__ void fused_infer_kernel(const int32_t* __restrict__ lit,      // [B, P, W]
                                   const int32_t* __restrict__ model,    // [C, W]
                                   const uint8_t* __restrict__ nonempty, // [C]
                                   const int8_t* __restrict__ weights,   // [M, C]
                                   int32_t* __restrict__ out,            // [B, M]
                                   int P, int C, int W, int M, int csrf) {
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * blockDim.x;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = c0 + tx;
  const bool valid = c < C;
  const bool live = valid && (kSparse || nonempty[c] != 0);
  const bool f = clause_tile::tile_fires<kSparse>(lit + (size_t)b * P * W, model, P, C, W,
                                                  c0, live, csrf);

  // Class sums of this tile: warp (ty, 32 clauses) reduces classes
  // m = ty, ty + kLanes, ... and adds its partial sum to out[b][m].
  for (int m = ty; m < M; m += blockDim.y) {
    int v = f ? (int)weights[(size_t)m * C + c] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((tx & 31) == 0 && v != 0) atomicAdd(out + (size_t)b * M + m, v);
  }
}

template <bool kSparse>
int launch(const void* lit, const void* model, const void* nonempty, const void* weights,
           void* out, int B, int P, int C, int W, int M, int block_c, int csrf,
           void* stream) {
  const int smem = clause_tile::smem_bytes(block_c, W);
  cudaError_t e = clause_tile::allow_smem(fused_infer_kernel<kSparse>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (C + block_c - 1) / block_c);
  dim3 block(block_c, kLanes);
  fused_infer_kernel<kSparse><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lit, (const int32_t*)model, (const uint8_t*)nonempty,
      (const int8_t*)weights, (int32_t*)out, P, C, W, M, csrf);
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
