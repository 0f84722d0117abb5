// The clause-tile datapath shared by fused_infer.cu and clause_eval.cu.
//
// One block owns one image and one tile of up to 256 clauses; it answers,
// for every clause of the tile, "does it fire on at least one patch"
// (the ASIC's sequential OR).  The model words of the tile sit in shared
// memory, rows padded to an odd stride so the 32 clauses of a warp hit
// 32 banks; patches are staged 32 at a time and split over kLanes patch
// lanes (threadIdx.y); a warp reads one patch's literal words as a
// broadcast.  The OR register is a shared-memory flag per clause.
//
// Two word tests, one loop (the kSparse template parameter):
//   dense  (model = include): a word is violated iff include & ~lit != 0;
//   sparse (model = exclude, ~include with pad bits set): a word is
//          violated iff ~(lit | exclude) != 0.
// Both stop at the first violated word.  The TPU's sparse kernels sum the
// popcount of every word and test the count against 0; the first
// violated word decides the same test.
//
// CSRF (clause-switching-reduction feedback, the paper's early exit) is a
// block-wide vote (__syncthreads_and) after each staged chunk: the patch
// loop stops once every clause of the tile has fired, counting clauses
// that cannot fire (empty ones on the dense path, rows past C on both) as
// saturated.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace clause_tile {

constexpr int kPatchChunk = 32;   // patches staged in shared memory per step
constexpr int kLanes = 4;         // patch lanes per clause (threadIdx.y)

// Dynamic shared memory of one block: the tile's model words, one staged
// chunk of literal words, and the OR register.
inline int smem_bytes(int block_c, int W) {
  return (int)sizeof(int32_t) * (block_c * (W | 1) + kPatchChunk * W + block_c);
}

template <bool kSparse>
__device__ __forceinline__ bool violated(int32_t model, int32_t lit) {
  return kSparse ? (~(lit | model)) != 0 : (model & ~lit) != 0;
}

// Runs the patch loop of one (image, clause tile) block and returns
// whether clause c0 + threadIdx.x fired on some patch; every thread of the
// block must call it.  `live` is false for clauses that cannot fire (rows
// past C, and empty clauses on the dense path): they are not evaluated
// and count as saturated in the CSRF vote.  Rows past C are staged as 0.
template <bool kSparse>
__device__ __forceinline__ bool tile_fires(const int32_t* __restrict__ lit_b,  // [P, W]
                                           const int32_t* __restrict__ model,  // [C, W]
                                           int P, int C, int W, int c0, bool live,
                                           int csrf) {
  extern __shared__ int32_t smem[];
  const int cc = blockDim.x;               // clauses in this tile (multiple of 32)
  const int wpad = W | 1;                  // odd row stride: conflict-free
  int32_t* model_s = smem;                 // [cc, wpad]
  int32_t* lit_s = model_s + cc * wpad;    // [kPatchChunk, W]
  int* fired_s = lit_s + kPatchChunk * W;  // [cc] sequential-OR register

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * cc + tx;
  const int nthreads = cc * blockDim.y;

  for (int i = tid; i < cc * W; i += nthreads) {
    const int r = i / W;
    const int w = i - r * W;
    model_s[r * wpad + w] = (c0 + r < C) ? model[(size_t)(c0 + r) * W + w] : 0;
  }
  if (ty == 0) fired_s[tx] = 0;

  for (int p0 = 0; p0 < P; p0 += kPatchChunk) {
    const int pc = min(kPatchChunk, P - p0);
    for (int i = tid; i < pc * W; i += nthreads) lit_s[i] = lit_b[(size_t)p0 * W + i];
    __syncthreads();
    if (live && !(csrf && fired_s[tx])) {
      const int32_t* mine = model_s + tx * wpad;
      for (int p = ty; p < pc; p += blockDim.y) {
        const int32_t* l = lit_s + p * W;
        bool fires = true;
        for (int w = 0; w < W; ++w) {
          if (violated<kSparse>(mine[w], l[w])) {
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
    if (csrf && __syncthreads_and(!live || fired_s[tx])) break;
  }
  __syncthreads();
  return live && fired_s[tx];
}

// Raises the kernel's dynamic shared-memory limit when a tile needs more
// than the 48 KB default (132 KB at the envelope, C=1024 and W=256).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace clause_tile
