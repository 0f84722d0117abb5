// Class sums (Eq. 3) from fired clause bits, on Hopper's int8 tensor cores
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/class_sum.py: class_sum_pallas
// (body class_sum_kernel): v[b][m] = sum_c w[m][c] * fired[b][c], int32
// [B, M], with fired 0/1 and weights in the int8 range.  The TPU kernel
// runs it as a float32 matmul on the MXU, exact because |v| <= 127 * C;
// here it is an s8 x s8 -> s32 product, exact by construction
// (|v| <= 128 * 1024 = 131,072 at the envelope C = 1024).
//
// Bound on this card: bytes.  The work is B*M*C multiply-adds on B*C + M*C
// input bytes and 4*B*M output bytes.  On the int8 tensor cores (132 SMs x
// 4,096 multiply-adds per clock) the operations take 0.3 ns at the paper's
// geometry (B=256, C=128, M=10) and 16 ns at the envelope (C=1024, M=64),
// against 13 ns and 117 ns for the bytes at 3.35 TB/s.  Both are far below
// one launch, so the kernel is latency-bound: it is one pass, with one
// round trip to memory for C <= 1024, no second kernel, no atomics and no
// zeroing of the output.
//
// Design.
//  - The product runs on mma.sync.m16n8k32.row.col.s32.s8.s8.s32.  fired
//    [B, C] (uint8 0/1: the same bits as s8 0/1) is operand A, row-major;
//    the weights [M, C] row-major are operand B, "col" (each class's
//    clauses contiguous).  Both fragments come from shared memory with
//    ldmatrix: one x4 for the 16 x 32-byte A tile, one x4 for the two n8
//    B tiles of a block's 16 classes.
//  - A block owns 16 images x 16 classes (two n8 tiles; M = 10 pads to
//    one block, M = 64 to four) and the whole clause axis.  Unlike a block
//    over all classes, the envelope's 64 KB of weights spread over four
//    blocks per image tile: each block pulls 32 KB at C = 1024, not 80 KB,
//    and the grid has 64 blocks at B = 256 instead of 16.  (8 classes a
//    block, 128 blocks, timed the same at both geometries.)
//  - The clause axis is split across the block's 8 warps: each chunk of
//    256 clauses is 8 k-steps of 32 bytes, warp w takes the w-th.  At the
//    envelope a warp does 4 chunks x 2 n-tiles = 8 mma; the 8 partial
//    16 x 16 tiles are added in shared memory (one output per thread).  A
//    warp whose k-step lies wholly past C skips its mma (warp-uniform).
//    With 4 warps, and twice the mma steps each, the kernel was slower
//    at both geometries: the serial work per warp sets its time, not the
//    bytes per block.
//  - Chunks are staged with cp.async into a ring of 4 stages (34,816 B of
//    static shared memory, under 48 KB), all issued before the first
//    wait: at C <= 1024 every chunk is in flight at once, one round trip
//    where a double buffer would take two.  A larger C refills each stage
//    after its chunk is consumed.  Bytes past C, images past B and
//    classes past M are zero-filled by cp.async's src-size, so the mma
//    loop has no branch on the ragged edges.
//  - Shared rows are padded to 272 bytes (16 mod 128): the 8 rows of each
//    ldmatrix phase fall into 8 distinct 16-byte bank groups.
//  - cp.async needs source addresses aligned to its size.  A fired row
//    starts at b*C bytes, so the launch picks the widest copy (16, 8 or 4
//    bytes) that C and both base addresses allow; C = 70 or C = 1 (and
//    misaligned bases) take byte loads into the same stages.
//  - Not chosen: one thread per (image, class) with __dp4a on 16-byte
//    loads.  It needs no shared memory or barrier, but each thread reads
//    a whole fired row and weight row, and it was slower at both
//    geometries (PERF.md).  wgmma is not used: a warpgroup takes 64 rows,
//    so B = 256 would make only four row tiles, and the mma steps are a
//    small part of the time, which goes to the staging round trip and
//    the barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kImages = 16;              // rows of the A tile: images per block
constexpr int kClasses = 16;             // two n8 tiles: classes per block
constexpr int kTiles = kClasses / 8;
constexpr int kWarps = 8;                // the clause axis splits across them
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32 * kWarps;      // clauses (bytes) per stage: one k-step per warp
constexpr int kStages = 1024 / kChunk;   // the envelope's whole clause axis in flight
constexpr int kStride = kChunk + 16;     // ldmatrix rows on distinct bank groups
constexpr int kRows = kImages + kClasses;
static_assert(kClasses % 16 == 0, "n8 tiles, loaded in pairs");
static_assert(kThreads == kImages * kClasses, "the epilogue gives one output to each thread");
static_assert(kStride % 128 == 16, "ldmatrix rows must fall on distinct bank groups");

// One stage: the block's kImages fired rows, then its kClasses weight rows,
// each kChunk bytes of one chunk.
struct Stage {
  uint8_t row[kRows][kStride];
};
static_assert(kStages * sizeof(Stage) <= 48 * 1024, "static shared memory");
static_assert(kWarps * kImages * kClasses * 4 <= kStages * (int)sizeof(Stage),
              "the K-split partial sums reuse the ring");

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One VEC-byte copy from global to shared memory; zero-filled when !valid
// (src-size 0: nothing is read, src only has to be a valid address).
template <int VEC>
__device__ __forceinline__ void copy(uint8_t* dst, const uint8_t* src, bool valid) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
  } else if constexpr (VEC == 8 || VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem(dst)), "l"(src),
                 "n"(VEC), "r"(valid ? VEC : 0));
  } else {
    static_assert(VEC == 1, "cp.async copies 4, 8 or 16 bytes; anything else goes bytewise");
    *dst = valid ? __ldg(src) : 0;
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Chunk [k0, k0 + kChunk) of the block's fired and weight rows into a stage.
template <int VEC>
__device__ __forceinline__ void load_chunk(Stage& s, const uint8_t* __restrict__ fired,
                                           const int8_t* __restrict__ weights, int B, int C,
                                           int M, int b0, int m0, int k0) {
  constexpr int kPerRow = kChunk / VEC;
  const uint8_t* w8 = reinterpret_cast<const uint8_t*>(weights);
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, k = (i % kPerRow) * VEC, c = k0 + k;
    const bool image = r < kImages;
    const int idx = image ? b0 + r : m0 + r - kImages;       // image b or class m
    const bool valid = c < C && idx < (image ? B : M);        // VEC divides C
    const uint8_t* base = image ? fired : w8;
    copy<VEC>(&s.row[r][k], valid ? base + (size_t)idx * C + c : base, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const uint8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem(p)));
}

// acc (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col).
__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    class_sum_kernel(const uint8_t* __restrict__ fired,   // [B, C]
                     const int8_t* __restrict__ weights,  // [M, C]
                     int32_t* __restrict__ out,           // [B, M]
                     int B, int C, int M) {
  __shared__ __align__(128) Stage ring[kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kImages, m0 = blockIdx.y * kClasses;
  const int chunks = (C + kChunk - 1) / kChunk;

  for (int s = 0; s < kStages; ++s) {      // every stage in flight before the first wait
    if (s < chunks) load_chunk<VEC>(ring[s], fired, weights, B, C, M, b0, m0, s * kChunk);
    commit();
  }

  // ldmatrix row addresses (bytes into a stage), lane l giving row l & 7 of
  // matrix l >> 3.  A: matrices (images 0-7, bytes 0-15), (8-15, 0-15),
  // (0-7, 16-31), (8-15, 16-31) of the warp's k-step: registers a0..a3 of
  // m16n8k32.  B: (classes 0-7, bytes 0-15), (0-7, 16-31), (8-15, 0-15),
  // (8-15, 16-31): b0, b1 of n-tile 0, then of n-tile 1.
  const int kstep = warp * 32;
  const int a_off = ((lane & 7) + (lane & 8)) * kStride + (lane >> 4) * 16 + kstep;
  const int b_off = (kImages + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                    ((lane >> 3) & 1) * 16 + kstep;
  int acc[kTiles][4] = {};
  for (int ch = 0; ch < chunks; ++ch) {
    wait_pending<kStages - 1>();           // chunk ch has landed (this thread's copies)
    __syncthreads();                       // ... and every thread's
    Stage& s = ring[ch % kStages];
    if (ch * kChunk + kstep < C) {         // warp-uniform: the k-step holds clauses
      const uint8_t* base = &s.row[0][0];
      uint32_t a[4];
      ldmatrix_x4(a, base + a_off);
#pragma unroll
      for (int t = 0; t < kTiles; t += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, base + b_off + 8 * t * kStride);
        mma_s8(acc[t], a, b[0], b[1]);
        mma_s8(acc[t + 1], a, b[2], b[3]);
      }
    }
    const int next = ch + kStages;
    if (next < chunks) {                   // C > 1024: refill this stage
      __syncthreads();
      load_chunk<VEC>(s, fired, weights, B, C, M, b0, m0, next * kChunk);
    }
    commit();
  }
  wait_pending<0>();
  __syncthreads();                         // every warp is done with the ring

  // K split: each warp's 16 x 16 partial tile into shared memory (the
  // ring), then one output per thread.  Accumulator c_i of n-tile t holds
  // row g (+8 for i >= 2), column 8t + 2q + (i & 1), g = lane / 4, q = lane % 4.
  auto part = reinterpret_cast<int32_t(*)[kImages][kClasses]>(&ring[0]);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp][g + 8 * (i >> 1)][8 * t + 2 * q + (i & 1)] = acc[t][i];
  __syncthreads();
  const int r = threadIdx.x / kClasses, n = threadIdx.x % kClasses;
  const int b = b0 + r, m = m0 + n;
  int v = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += part[w][r][n];
  if (b < B && m < M) out[(size_t)b * M + m] = v;
}

template <int VEC>
void launch(const void* fired, const void* weights, void* out, int B, int C, int M,
            cudaStream_t stream) {
  dim3 grid((B + kImages - 1) / kImages, (M + kClasses - 1) / kClasses);
  class_sum_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)fired, (const int8_t*)weights, (int32_t*)out, B, C, M);
}

}  // namespace

// fired: uint8 0/1 [B, C]; weights: int8 [M, C]; out: int32 [B, M], every
// element written.  B, C, M >= 1.  Returns cudaGetLastError().
extern "C" int class_sum(const void* fired, const void* weights, void* out, int B, int C,
                         int M, void* stream) {
  // The widest copy that every row start (a multiple of C) and both bases allow.
  const unsigned align = (unsigned)C | (unsigned)(uintptr_t)fired | (unsigned)(uintptr_t)weights;
  cudaStream_t s = (cudaStream_t)stream;
  if (align % 16 == 0) launch<16>(fired, weights, out, B, C, M, s);
  else if (align % 8 == 0) launch<8>(fired, weights, out, B, C, M, s);
  else if (align % 4 == 0) launch<4>(fired, weights, out, B, C, M, s);
  else launch<1>(fired, weights, out, B, C, M, s);
  return (int)cudaGetLastError();
}
