// Sequential-OR clause outputs, for Hopper (sm_90a): the dense clause
// pool and the active (sparse) clause pool.
//
// Replaces two TPU kernels of src/repro/kernels/clause_eval.py:
//   * clause_eval_pallas (body clause_eval_kernel): uint8 0/1 [B, C]; a
//     clause fires iff include & ~lit == 0 on every word of at least one
//     patch, and it is nonempty;
//   * clause_eval_sparse_pallas (body clause_eval_sparse_kernel): uint8
//     0/1 [B, C_a] for the active clauses, from exclude words (~include,
//     pad bits set); a clause fires iff ~(lit | exclude) == 0 on every
//     word of at least one patch.  The TPU kernel sums popcounts over all
//     words and tests the count against 0; here the first violated word
//     ends the test, which decides the same thing.
//
// Bound on this card: bytes, as for fused_infer.cu (clause_tile.cuh gives
// the numbers); the output adds one byte per (image, clause).
//
// Design: the block, staging, patch loop and per-clause CSRF are those
// of the fused kernel (clause_tile.cuh), one block per image and tile of
// up to 128 clauses.  The epilogue writes one uint8 per (image, clause)
// straight from the tile's fired flags: no int32 output, no cast on the
// host, and no atomics, since each block owns its outputs.  Rows of the
// tile past C write nothing; empty clauses write 0.

#include "clause_tile.cuh"

namespace {

template <bool kSparse>
__global__ void __launch_bounds__(32 * clause_tile::kMaxWarps, 2)
clause_eval_kernel(const int32_t* __restrict__ lit,      // [B, P, W]
                   const int32_t* __restrict__ model,    // [C, W]
                   const uint8_t* __restrict__ nonempty, // [C] or null
                   uint8_t* __restrict__ out,            // [B, C]
                   int P, int C, int W, int block_c, int chunk, int csrf) {
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * block_c;
  const int* fired = clause_tile::tile_fires<kSparse>(
      lit + (size_t)b * P * W, model, nonempty, P, C, W, c0, block_c, chunk, csrf);
  const int rows = min(block_c, C - c0);
  for (int k = threadIdx.x; k < rows; k += blockDim.x)
    out[(size_t)b * C + c0 + k] = (uint8_t)fired[k];
}

template <bool kSparse>
int launch(const void* lit, const void* model, const void* nonempty, void* out, int B,
           int P, int C, int W, int block_c, int csrf, void* stream) {
  int smem = 0;
  const int chunk = clause_tile::plan_chunk(P, W, block_c, &smem);
  cudaError_t e = clause_tile::allow_smem(clause_eval_kernel<kSparse>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (C + block_c - 1) / block_c);
  clause_eval_kernel<kSparse><<<grid, 32 * clause_tile::warps_for(block_c), smem,
                                (cudaStream_t)stream>>>(
      (const int32_t*)lit, (const int32_t*)model, (const uint8_t*)nonempty,
      (uint8_t*)out, P, C, W, block_c, chunk, csrf);
  return (int)cudaGetLastError();
}

}  // namespace

// lit: int32 [B, P, W]; inc: int32 [C, W]; nonempty: uint8 [C];
// out: uint8 [B, C], every element written.  block_c: clauses per tile,
// a multiple of 32 and at most 256.  Returns cudaGetLastError().
extern "C" int clause_eval(const void* lit, const void* inc, const void* nonempty,
                           void* out, int B, int P, int C, int W, int block_c, int csrf,
                           void* stream) {
  return launch<false>(lit, inc, nonempty, out, B, P, C, W, block_c, csrf, stream);
}

// The active clause pool: exc: int32 [C_a, W] exclude words; out: uint8
// [B, C_a], every element written.  C_a >= 1.
extern "C" int clause_eval_sparse(const void* lit, const void* exc, void* out, int B,
                                  int P, int C, int W, int block_c, int csrf,
                                  void* stream) {
  return launch<true>(lit, exc, nullptr, out, B, P, C, W, block_c, csrf, stream);
}
