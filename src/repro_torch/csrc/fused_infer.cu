// Fused clause evaluation + class sums, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_infer.py:
// fused_infer_pallas (body _kernel).  Same function: a clause fires on a
// patch iff include & ~lit == 0 on every word; it fires for the image
// iff it fires on at least one patch (sequential OR) and is nonempty;
// class sums are sum_c w[m][c] * fired[c] in int32.
//
// Bound on this card: bytes while work stops early, operations when it
// does not.  The packed literals are the only large input (P*W words per
// image, 12,996 B at the paper's geometry); the test is one AND-NOT per
// word, and most clauses of a real pool are violated on the first word,
// so the kernel must above all read each literal word once and keep
// every thread busy.
//
// Design, against the TPU kernel's sequential grid: the Pallas grid runs
// in order and carries the OR register across patch chunks and the class
// sums across clause blocks.  CUDA blocks run in parallel and in no
// order, so here
//   * one block owns one image and one tile of up to 128 clauses, and
//     the patch loop runs inside the block; 4 patch lanes (threadIdx.y)
//     split each staged chunk of 32 patches, and the OR register is a
//     shared-memory flag per clause;
//   * the tile's include words sit in shared memory, rows padded to an
//     odd stride so the 32 clauses of a warp hit 32 banks; a warp reads
//     one patch's literal words as a broadcast;
//   * CSRF is a block-wide vote (__syncthreads_and) after each chunk: the
//     patch loop stops once every clause of the tile has fired, counting
//     empty clauses and rows past C as saturated (the TPU tile with one
//     empty clause never saturated);
//   * clause tiles combine their partial class sums with int32 atomicAdd,
//     exact in any order; the caller zeroes the output.
// At the envelope (C=1024, W=256) a tile's include words take 132 KB of
// shared memory, above the 48 KB default, so the launch raises the
// kernel's dynamic shared-memory limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatchChunk = 32;   // patches staged in shared memory per step
constexpr int kLanes = 4;         // patch lanes per clause (threadIdx.y)

__global__ void fused_infer_kernel(const int32_t* __restrict__ lit,      // [B, P, W]
                                   const int32_t* __restrict__ inc,      // [C, W]
                                   const uint8_t* __restrict__ nonempty, // [C]
                                   const int8_t* __restrict__ weights,   // [M, C]
                                   int32_t* __restrict__ out,            // [B, M]
                                   int P, int C, int W, int M, int csrf) {
  extern __shared__ int32_t smem[];
  const int cc = blockDim.x;               // clauses in this tile (multiple of 32)
  const int wpad = W | 1;                  // odd row stride: conflict-free
  int32_t* inc_s = smem;                   // [cc, wpad]
  int32_t* lit_s = inc_s + cc * wpad;      // [kPatchChunk, W]
  int* fired_s = lit_s + kPatchChunk * W;  // [cc] sequential-OR register

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * cc;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * cc + tx;
  const int nthreads = cc * blockDim.y;
  const int c = c0 + tx;
  const bool valid = c < C;
  const bool ne = valid && nonempty[c] != 0;

  for (int i = tid; i < cc * W; i += nthreads) {
    const int r = i / W;
    const int w = i - r * W;
    inc_s[r * wpad + w] = (c0 + r < C) ? inc[(size_t)(c0 + r) * W + w] : 0;
  }
  if (ty == 0) fired_s[tx] = 0;

  const int32_t* lit_b = lit + (size_t)b * P * W;
  for (int p0 = 0; p0 < P; p0 += kPatchChunk) {
    const int pc = min(kPatchChunk, P - p0);
    for (int i = tid; i < pc * W; i += nthreads) lit_s[i] = lit_b[(size_t)p0 * W + i];
    __syncthreads();
    if (valid && !(csrf && fired_s[tx])) {
      const int32_t* my_inc = inc_s + tx * wpad;
      for (int p = ty; p < pc; p += blockDim.y) {
        const int32_t* l = lit_s + p * W;
        bool fires = true;
        for (int w = 0; w < W; ++w) {
          if (my_inc[w] & ~l[w]) {
            fires = false;
            break;
          }
        }
        if (fires) {
          fired_s[tx] = 1;                 // every writer stores the same value
          if (csrf) break;
        }
      }
    }
    __syncthreads();                       // fired_s complete; lit_s free again
    if (csrf && __syncthreads_and(!ne || fired_s[tx])) break;
  }
  __syncthreads();

  // Class sums of this tile: warp (ty, 32 clauses) reduces classes
  // m = ty, ty + kLanes, ... and adds its partial sum to out[b][m].
  const bool f = ne && fired_s[tx];
  for (int m = ty; m < M; m += blockDim.y) {
    int v = f ? (int)weights[(size_t)m * C + c] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((tx & 31) == 0 && v != 0) atomicAdd(out + (size_t)b * M + m, v);
  }
}

}  // namespace

// lit: int32 [B, P, W]; inc: int32 [C, W]; nonempty: uint8 [C];
// weights: int8 [M, C]; out: int32 [B, M], zero on entry.
// block_c: clauses per tile, a multiple of 32 and at most 256.
// Returns cudaGetLastError().
extern "C" int fused_infer(const void* lit, const void* inc, const void* nonempty,
                           const void* weights, void* out, int B, int P, int C, int W,
                           int M, int block_c, int csrf, void* stream) {
  const int smem =
      (int)sizeof(int32_t) * (block_c * (W | 1) + kPatchChunk * W + block_c);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_infer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, (C + block_c - 1) / block_c);
  dim3 block(block_c, kLanes);
  fused_infer_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lit, (const int32_t*)inc, (const uint8_t*)nonempty,
      (const int8_t*)weights, (int32_t*)out, P, C, W, M, csrf);
  return (int)cudaGetLastError();
}
