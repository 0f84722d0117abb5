// The clause-tile datapath shared by fused_infer.cu and clause_eval.cu.
//
// One block owns one image and one tile of up to 256 clauses; it answers,
// for every clause of the tile, "does it fire on at least one patch"
// (the ASIC's sequential OR).
//
// Two word tests, one loop (the kSparse template parameter):
//   dense  (model = include): a word is violated iff include & ~lit != 0;
//   sparse (model = exclude, ~include with pad bits set): a word is
//          violated iff ~(lit | exclude) != 0.
// Each is one LOP3.  The TPU's sparse kernels sum the popcount of every
// word and test the count against 0; the first violated word decides the
// same test.
//
// Bound on this card: bytes.  The literals are the only large input,
// 3.3 MB at B=256 (about 1.0 us at 3.35 TB/s).  The operation floor is
// one word test per (image, clause, patch) up to the clause's first
// firing patch, each counting the words up to the first violated one:
// 11.9M tests for the boundary pool at B=256, 0.71 us at 64 integer
// results per clock per SM (about 16.7e12 per second on an H100 SXM).
// The loop as built is limited by integer instruction throughput, at
// about 3.5 lane operations per word-0 test (the test, its predicate,
// the bit it sets).
//
// Staging: the image's packed literals are copied into shared memory
// with cp.async (16-byte copies where global and shared addresses share
// their alignment, 4-byte ones at the edges), and so are the tile's
// model words.  At the paper's geometry the whole image (P*W*4 = 12,996
// B) fits, so there is one wait and one barrier before the patch loop and
// none inside it.  An image that does not fit (the envelope: P=2048,
// W=256) goes through a double-buffered ring of 32-patch-multiple
// chunks: the next chunk is in flight while the current one is tested,
// with one barrier per chunk.  Literal rows use an odd stride (W | 1), so
// 32 lanes on 32 patches hit 32 banks.
//
// Mapping: lanes take patches and loops take clauses.  Warp 0 compacts
// the tile's live rows (all rows on the sparse path, the nonempty ones on
// the dense path; rows past C never) with ballots, and each warp owns
// every nwarps-th live row, so warps get equal shares and no atomics hand
// out work.  A pass covers 384 patches: each lane holds the first literal
// word of its 12 patches (lane + 32 j) in registers, and for each owned
// clause tests all 12 against the clause's first word (a shared-memory
// broadcast), setting bit j of a pending mask for the patches that pass
// it.  Most clauses fail word 0 on every patch, and one warp vote ends
// them there.  The rest walk words 1.. on their pending patches only:
// when no lane holds two, one step covers them all; otherwise the lanes
// walk them four at a time, in slot groups that hold a pending patch.
// Every step ends on a warp vote (__any_sync) once no lane is still
// alive, not on a per-lane break, and a patch that passes every word
// fires the clause.  Lanes past the image's last patch repeat it: a
// duplicate patch leaves the OR as it is.
//
// CSRF (clause-switching-reduction feedback, the paper's early exit) is
// per clause and warp-uniform: once a clause has fired, its warp stops
// testing it and moves on, so a clause that never fires costs only its
// own walk and holds no other clause in the loop.  With chunks, the
// per-chunk barrier is also a vote (__syncthreads_or): the ring stops
// once no live clause of the tile is still unfired.  The csrf flag
// switches these exits and never the result.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace clause_tile {

constexpr int kClausesPerWarp = 4;   // warps of a block: block_c / 4, at most kMaxWarps
constexpr int kMaxWarps = 16;        // 512 threads: the registers of two blocks fit an SM
constexpr int kMaxTile = 256;        // clauses of a tile at most
constexpr int kPatchRegs = 12;       // first literal words a lane holds in registers
constexpr int kPassPatches = 32 * kPatchRegs;   // patches per pass: 384 (P=361 in one)
constexpr int kGroup = 4;            // pending patches a lane walks per step
constexpr int kMaxSmemBytes = 232448;       // what one block may use on Hopper
constexpr int kWholeImageBytes = 100 * 1024;  // stage the whole image up to this

// Warps of a block for a tile of block_c clauses (a multiple of 32).
__host__ __device__ inline int warps_for(int block_c) {
  return block_c / kClausesPerWarp < kMaxWarps ? block_c / kClausesPerWarp : kMaxWarps;
}

__host__ __device__ inline int round4(int words) { return (words + 3) & ~3; }

// Shared-memory regions, in 32-bit words, each starting 16-byte aligned:
// the model tile [block_c, W] (+3 words of alignment slack), the fired
// flags [block_c], the live rows [block_c] and their count, then one or
// two literal buffers [chunk, W | 1] (+3).
__host__ __device__ inline int model_words(int block_c, int W) {
  return round4(block_c * W + 3);
}
__host__ __device__ inline int buffer_words(int chunk, int W) {
  return round4(chunk * (W | 1) + 3);
}
__host__ __device__ inline int flag_words(int block_c) { return round4(2 * block_c + 1); }

// Patches staged per step: all P when the image fits in kWholeImageBytes
// beside the model tile, else the largest multiple of 32 that lets two
// buffers fit.  Returns the block's dynamic shared memory in *smem.
inline int plan_chunk(int P, int W, int block_c, int* smem) {
  const int whole = model_words(block_c, W) + flag_words(block_c) + buffer_words(P, W);
  if (4 * whole <= kWholeImageBytes) {
    *smem = 4 * whole;
    return P;
  }
  auto bytes = [&](int chunk) {
    return 4 * (model_words(block_c, W) + flag_words(block_c) + 2 * buffer_words(chunk, W));
  };
  int chunk = 32;
  while (chunk + 32 < P && bytes(chunk + 32) <= kMaxSmemBytes) chunk += 32;
  *smem = bytes(chunk);
  return chunk;
}

// 32-bit words from global memory at word alignment: `dst` must sit at
// the same offset within 16 bytes as `src` (see aligned_dst).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The place in a 16-byte-aligned region where a copy of `src` starts, so
// that both sides share their offset within 16 bytes.
__device__ __forceinline__ int32_t* aligned_dst(int32_t* region, const int32_t* src) {
  return region + (((uintptr_t)src >> 2) & 3);
}

// Starts (does not wait for) the copy of n contiguous words.
__device__ __forceinline__ void stage_words(int32_t* dst, const int32_t* src, int n) {
  const int head = min(n, (int)((4 - (((uintptr_t)src >> 2) & 3)) & 3));
  const int body = (n - head) >> 2;           // 16-byte copies
  for (int i = threadIdx.x; i < head; i += blockDim.x) cp_async4(dst + i, src + i);
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// Starts the copy of `rows` literal rows of W words into rows of stride
// W | 1: contiguous when W is odd, word by word when it is even.
__device__ __forceinline__ void stage_lits(int32_t* dst, const int32_t* src, int rows, int W) {
  if (W & 1) {
    stage_words(dst, src, rows * W);
    return;
  }
  const int ws = W | 1;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int r = i / W;
    cp_async4(dst + r * ws + (i - r * W), src + i);
  }
}

template <bool kSparse>
__device__ __forceinline__ bool violated(int32_t model, int32_t lit) {
  return (kSparse ? ~(lit | model) : (model & ~lit)) != 0;
}

// Runs the patch loop of one (image, clause tile) block and returns the
// tile's fired flags in shared memory (fired[k] for clause c0 + k, 0 or
// 1, k < min(block_c, C - c0)); every thread of the block must call it,
// with blockDim.x == 32 * warps_for(block_c) and `chunk` from
// plan_chunk.  `nonempty` is null on the sparse path (every row live).
template <bool kSparse>
__device__ __forceinline__ const int* tile_fires(const int32_t* __restrict__ lit_b,  // [P, W]
                                                 const int32_t* __restrict__ model,  // [C, W]
                                                 const uint8_t* __restrict__ nonempty,
                                                 int P, int C, int W, int c0, int block_c,
                                                 int chunk, int csrf) {
  extern __shared__ __align__(16) int32_t smem[];
  const int ws = W | 1;
  const int rows = min(block_c, C - c0);
  const int32_t* model_src = model + (size_t)c0 * W;
  int32_t* model_s = aligned_dst(smem, model_src);
  int* fired_s = smem + model_words(block_c, W);
  int* live_s = fired_s + block_c;            // live tile rows, then their count
  int32_t* ring = fired_s + flag_words(block_c);
  const int buf = buffer_words(chunk, W);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  stage_words(model_s, model_src, rows * W);
  stage_lits(aligned_dst(ring, lit_b), lit_b, min(chunk, P), W);
  cp_async_commit();

  // The rows that can fire (all of them on the sparse path), compacted
  // by warp 0 so that the warps get equal shares: rows past C and empty
  // clauses are never tested.
  for (int i = threadIdx.x; i < block_c; i += blockDim.x) fired_s[i] = 0;
  if (warp == 0) {
    bool lv[kMaxTile / 32];                 // all loads in flight at once
#pragma unroll
    for (int t = 0; t < kMaxTile / 32; ++t) {
      const int r = 32 * t + lane;
      lv[t] = r < rows && (nonempty == nullptr || nonempty[c0 + r]);
    }
    int n = 0;
#pragma unroll
    for (int t = 0; t < kMaxTile / 32; ++t) {
      const uint32_t votes = __ballot_sync(0xffffffffu, lv[t]);
      if (lv[t]) live_s[n + __popc(votes & ((1u << lane) - 1))] = 32 * t + lane;
      n += __popc(votes);
    }
    if (lane == 0) live_s[block_c] = n;
  }

  // This warp's live rows are live_s[warp + i * nwarps], i < owned; bit i
  // of `fired` says row i has fired.
  int owned = 0;
  uint32_t fired = 0;

  for (int p0 = 0, step = 0; p0 < P; p0 += chunk, ++step) {
    const int pc = min(chunk, P - p0);
    if (p0 + chunk < P) {                   // prefetch the next chunk into the other buffer
      const int32_t* next = lit_b + (size_t)(p0 + chunk) * W;
      stage_lits(aligned_dst(ring + ((step + 1) & 1) * buf, next), next,
                 min(chunk, P - p0 - chunk), W);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    owned = (live_s[block_c] - warp + nwarps - 1) / nwarps;
    const int32_t* lit_s = aligned_dst(ring + (step & 1) * buf, lit_b + (size_t)p0 * W);

    for (int g = 0; g < pc; g += kPassPatches) {
      // This lane's patches of the pass: g + lane + 32 j, those past the
      // chunk replaced by its last patch (a duplicate leaves the OR as it
      // is); their first words stay in registers for every clause.
      int32_t first[kPatchRegs];
#pragma unroll
      for (int j = 0; j < kPatchRegs; ++j)
        first[j] = lit_s[min(g + lane + 32 * j, pc - 1) * ws];

      for (int i = 0; i < owned; ++i) {
        const uint32_t bit = 1u << i;
        if (csrf && (fired & bit)) continue;
        const int32_t* m = model_s + live_s[warp + i * nwarps] * W;
        const int32_t m0 = m[0];
        uint32_t pending = 0;               // bit j: patch j of this lane passes word 0
#pragma unroll
        for (int j = 0; j < kPatchRegs; ++j)
          pending |= (uint32_t)!violated<kSparse>(m0, first[j]) << j;
        // Most clauses fail word 0 on every patch and stop here.
        if (!__any_sync(0xffffffffu, pending != 0)) continue;
        if (!__any_sync(0xffffffffu, (pending & (pending - 1)) != 0)) {
          // At most one pending patch per lane: one step walks them all.
          bool alive = pending != 0;
          const int j = alive ? __ffs(pending) - 1 : 0;
          const int32_t* l = lit_s + min(g + lane + 32 * j, pc - 1) * ws;
          bool any = true;
          for (int w = 1; w < W && any; ++w) {
            alive &= !violated<kSparse>(m[w], l[w]);
            any = __any_sync(0xffffffffu, alive);
          }
          if (any) fired |= bit;
          continue;
        }
        // Many pending patches: walk them kGroup per lane per step, in
        // slot groups that hold a pending patch, until a group fires.
#pragma unroll
        for (int j0 = 0; j0 < kPatchRegs; j0 += kGroup) {
          const uint32_t slots = (pending >> j0) & ((1u << kGroup) - 1);
          if (!__any_sync(0xffffffffu, slots != 0)) continue;
          bool alive[kGroup];
          const int32_t* l[kGroup];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            alive[q] = (slots >> q) & 1;
            l[q] = lit_s + min(g + lane + 32 * (j0 + q), pc - 1) * ws;
          }
          bool any = true;
          for (int w = 1; w < W && any; ++w) {
            const int32_t mw = m[w];
            bool any_lane = false;
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
              alive[q] &= !violated<kSparse>(mw, l[q][w]);
              any_lane |= alive[q];
            }
            any = __any_sync(0xffffffffu, any_lane);
          }
          if (any) {
            fired |= bit;
            if (csrf) break;
          }
        }
      }
    }

    if (p0 + chunk < P) {                   // the buffer is refilled next step
      if (!__syncthreads_or(__popc(fired) < owned || !csrf)) break;
    }
  }
  cp_async_wait<0>();                       // no copy may outlive the block

  if (lane == 0)
    for (int i = 0; i < owned; ++i)
      if ((fired >> i) & 1) fired_s[live_s[warp + i * nwarps]] = 1;
  __syncthreads();
  return fired_s;
}

// Raises the kernel's dynamic shared-memory limit when a tile needs more
// than the 48 KB default (the envelope, C=1024 and W=256, stages its
// model tile and two literal chunks in about 197 KB).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace clause_tile
