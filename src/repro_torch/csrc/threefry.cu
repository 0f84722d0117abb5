// Threefry2x32-20 over K keys x N counters, for Hopper (sm_90a): the
// counter hash behind jax.random's keys, whose stream the port draws.
//
// Replaces no Pallas kernel: the reference's random numbers come from
// XLA's lowering of jax.random's threefry2x32 primitive
// (jax/_src/prng.py, _threefry2x32_lowering), partitionable form: the
// counter of element i is the 64-bit start + i as (high word, low word),
// each key hashes each counter to two words (b1, b2), and
//   * mode 0 writes b1 ^ b2 (random_bits, 32 bits) as int32 [K, N];
//   * mode 1 writes float32 uniforms in [minval, minval + span): the
//     top 23 bits of b1 ^ b2 under the exponent of 1.0, minus 1, times
//     span plus minval in one fused multiply-add (XLA fuses the
//     reference's multiply and add), at least minval (jax.random._uniform);
//   * mode 2 writes (b1, b2) as int32 [K, N, 2] (split).
//
// Bound on this card: integer throughput.  A hash is 77 integer operations
// (two key adds, 20 rounds of add / rotate / xor, five key injections of
// three adds) against 4 or 8 bytes written, so at 64 results per clock
// per SM the operations take 2-4x the time of the stores.
//
// Design: one thread per (key, counter), the 20 rounds unrolled in
// registers, each rotation one funnel shift (SHF), no shared memory.
// Consecutive threads take consecutive counters of one key, so every
// store is coalesced; grid.y walks the keys (a loop past 65,535).  The
// float arithmetic is written with round-to-nearest intrinsics, so the
// uniforms round as the reference's (and the plain PyTorch version's)
// one fused multiply-add rounds, whatever nvcc would contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
}

constexpr int kThreads = 256;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint32_t* __restrict__ keys,  // [K, 2]
                int K, long long N, unsigned long long start, float minval, float span,
                void* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const unsigned long long c = start + (unsigned long long)i;
  for (int k = blockIdx.y; k < K; k += gridDim.y) {
    uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
    threefry2x32(keys[2 * k], keys[2 * k + 1], x0, x1);
    const size_t o = (size_t)k * (size_t)N + (size_t)i;
    if (kMode == 0) {
      ((uint32_t*)out)[o] = x0 ^ x1;
    } else if (kMode == 1) {
      float f = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u);
      f = __fmaf_rn(__fsub_rn(f, 1.0f), span, minval);
      ((float*)out)[o] = fmaxf(minval, f);
    } else {
      ((uint2*)out)[o] = make_uint2(x0, x1);
    }
  }
}

template <int kMode>
void launch(const void* keys, int K, long long N, unsigned long long start, float minval,
            float span, void* out, cudaStream_t stream) {
  dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)(K < 65535 ? K : 65535));
  threefry_kernel<kMode><<<grid, kThreads, 0, stream>>>(
      (const uint32_t*)keys, K, N, start, minval, span, out);
}

}  // namespace

extern "C" int threefry(const void* keys, int K, long long N, unsigned long long start,
                        int mode, float minval, float span, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) launch<0>(keys, K, N, start, minval, span, out, s);
  else if (mode == 1) launch<1>(keys, K, N, start, minval, span, out, s);
  else if (mode == 2) launch<2>(keys, K, N, start, minval, span, out, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
