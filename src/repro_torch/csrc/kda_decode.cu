// One decode step of Kimi Delta Attention's recurrence (arXiv:2510.26692,
// Sec. 3), for Hopper (sm_90a), on a layer's state in place:
//
//   S'  = Diag(exp g) S                      (the per-channel decay)
//   u   = k^T S'                             (what the state recalls of k)
//   S'' = S' + (beta k) (v - u)^T            (the delta rule's rank-1 update)
//   o   = S''^T q
//
// with S [BH, DK, DV] float32 row-major (a row per key channel), q, k, g
// [BH, DK], v [BH, DV], beta [BH], o [BH, DV], all float32, BH the batch
// times the heads.
//
// Replaces no Pallas kernel: the reference has no delta rule.  It was
// added because in a decode step the state is nearly all the bytes of a
// KDA layer (Kimi-Linear-48B-A3B: 32 heads x 128 x 128 float32 = 2 MiB a
// sequence and layer), and the same step in torch operations reads or
// writes it about six times (decay, k^T S, the outer product, the add,
// S^T q).
//
// Bound on this card: memory.  Each state element is read once and
// written once (8 bytes) for 6 flops, far below the ~20 flops a byte at
// which float32 arithmetic would bound it.
//
// Design: a block takes one (sequence, head) and 32 columns of DV; its 8
// warps split the DK rows, DK / 8 consecutive rows to a warp, and a lane
// takes one column.  A lane holds its DK / 8 values of its column in
// registers between the read and the write, so S is read once; the 32
// lanes of a warp take 32 consecutive columns of a row, so each load and
// store is 128 coalesced bytes.  Columns are independent (u, the update and
// o of column j read only column j of S): the only sums that cross threads
// are a column's u and o over its 8 row slices, through shared memory, in
// a fixed order.  k, beta k, q and exp(g) go through shared memory once a
// block.  (A first design gave a thread a whole column, DK values in
// registers: at DK = 128 ptxas put them on the stack, 3.3 KB of spills a
// thread, 2.84 ms a launch at B = 256 against a bound of 0.33 ms.)

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 32;

template <int DK>
__global__ void __launch_bounds__(kWarps * 32)
kda_decode_kernel(float* __restrict__ S, const float* __restrict__ q,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ g, const float* __restrict__ beta,
                  float* __restrict__ o, int dv) {
  constexpr int R = DK / kWarps;
  __shared__ float ks[DK], bks[DK], qs[DK], es[DK];
  __shared__ float part[kWarps][kCols];
  const long long bh = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.y * kCols + lane;
  const bool live = col < dv;
  const float b = beta[bh];
  for (int i = threadIdx.x; i < DK; i += blockDim.x) {
    const float ki = k[bh * DK + i];
    ks[i] = ki;
    bks[i] = b * ki;
    qs[i] = q[bh * DK + i];
    es[i] = expf(g[bh * DK + i]);
  }
  __syncthreads();
  const int r0 = warp * R;
  float* s = S + (bh * DK + r0) * dv + col;
  float reg[R];
  float u = 0.f;
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) reg[r] = s[(long long)r * dv];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      reg[r] *= es[r0 + r];
      u = fmaf(ks[r0 + r], reg[r], u);
    }
  }
  part[warp][lane] = u;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[w][lane];
  __syncthreads();                         // every lane has read part: it is written anew
  float out = 0.f;
  if (live) {
    const float delta = v[bh * dv + col] - total;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float n = fmaf(bks[r0 + r], delta, reg[r]);
      s[(long long)r * dv] = n;
      out = fmaf(qs[r0 + r], n, out);
    }
  }
  part[warp][lane] = out;
  __syncthreads();
  if (warp == 0 && live) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][lane];
    o[bh * dv + col] = sum;
  }
}

template <int DK>
cudaError_t launch(float* S, const float* q, const float* k, const float* v, const float* g,
                   const float* beta, float* o, int bh, int dv, cudaStream_t stream) {
  dim3 grid(bh, (dv + kCols - 1) / kCols);
  kda_decode_kernel<DK><<<grid, kWarps * 32, 0, stream>>>(S, q, k, v, g, beta, o, dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kda_decode(void* S, const void* q, const void* k, const void* v,
                          const void* g, const void* beta, void* o, int bh, int dk, int dv,
                          void* stream) {
  if (dk != dv) return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(S);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(beta);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 16: return (int)launch<16>(s, qf, kf, vf, gf, bf, of, bh, dv, st);
    case 128: return (int)launch<128>(s, qf, kf, vf, gf, bf, of, bh, dv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
