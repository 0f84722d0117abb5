// Class sums (Eq. 3) from fired clause bits, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/class_sum.py: class_sum_pallas
// (body class_sum_kernel): v[b][m] = sum_c w[m][c] * fired[b][c], int32
// [B, M], with fired 0/1 and weights in the int8 range.  The TPU kernel
// runs it as a float32 matmul on the MXU, exact because |v| <= 127 * C;
// here it is integer arithmetic throughout, exact by construction.
//
// Bound on this card: operations.  The work is B*M*C integer multiply-adds
// (one IMAD, one result, per image, class and clause) on B*C + M*C input
// bytes and 4*B*M output bytes.  At the paper's geometry and B=256 that is
// 327,680 operations, 0.0196 us at 64 results per clock per SM on 132 SMs
// at 1.98 GHz, against 0.0132 us for the 44 KB at 3.35 TB/s.  Both are far
// below a launch's latency, so the design keeps it to one pass with no
// second kernel, no atomics and no zeroing of the output.
//
// Design, against the TPU kernel's sequential grid (which carries the
// f32 accumulator across clause blocks in the output tile): one warp owns
// one (image, class) output and walks the clause axis itself, 32 clauses
// a step with neighbouring lanes on neighbouring bytes, then reduces
// across the warp with shuffles.  The weights stream from device memory
// through the L1 and L2 caches (64 KB at the envelope, M=64 and C=1024)
// rather than being staged in shared memory: each block reads only the
// rows of its own classes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // classes per block, one warp each

__global__ void class_sum_kernel(const uint8_t* __restrict__ fired,   // [B, C]
                                 const int8_t* __restrict__ weights,  // [M, C]
                                 int32_t* __restrict__ out,           // [B, M]
                                 int C, int M) {
  const int b = blockIdx.x;
  const int m = blockIdx.y * kWarps + (int)(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;                     // whole warps only: no barrier below
  const uint8_t* f = fired + (size_t)b * C;
  const int8_t* w = weights + (size_t)m * C;
  int v = 0;
  for (int c = lane; c < C; c += 32) v += (int)f[c] * (int)w[c];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) out[(size_t)b * M + m] = v;
}

}  // namespace

// fired: uint8 0/1 [B, C]; weights: int8 [M, C]; out: int32 [B, M], every
// element written.  B, M >= 1.  Returns cudaGetLastError().
extern "C" int class_sum(const void* fired, const void* weights, void* out, int B, int C,
                         int M, void* stream) {
  dim3 grid(B, (M + kWarps - 1) / kWarps);
  class_sum_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)fired, (const int8_t*)weights, (int32_t*)out, C, M);
  return (int)cudaGetLastError();
}
