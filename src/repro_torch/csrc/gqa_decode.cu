// One decode step of grouped-query attention on a KV cache, for Hopper
// (sm_90a):
//
//   s[g, i] = (q[g] . k[i]) * scale             float32 dot products
//   w[g, i] = softmax_i(s[g, :])                 float32: max, exp, sum, divide
//   o[g]    = sum_i T(w[g, i]) * v[i]            float32 sums, rounded once to T
//
// over the visible slots i of one (sequence, kv head), for each of its G
// query heads, with q [BKV, G, HD] and the caches k, v [BKV, N, HD] in T
// (bf16, fp16 or float32) and BKV the batch times the kv heads.  T(w) is
// the weight rounded to the values' type before it weights them, as the
// plain version (``models/attention.py:_sdpa``) casts the softmax.
//
// Replaces no Pallas kernel: the reference attends with XLA's operations.
// It was added because in a decode step the plain version widens the whole
// K cache to float32 in every layer (a read of the cache, a float32 copy
// written and read back), scores it on the CUDA cores as a batch of
// [G, HD] x [HD, S] float32 products, and then runs the mask, softmax and
// casts as separate passes, over every slot of the cache whether visible
// or not.
//
// A cache is a ring of S slots; k and v hold its slots first .. first + N
// - 1 (a whole cache: first 0, N = S).  Three modes:
//   whole  (N = S)  the softmax and the output o [BKV, G, HD] in T;
//   stats           of a block of the ring: each query head's maximum score
//                   over the block's visible slots and the sum of exp(s -
//                   max) (-inf and 0 where it has none), float2 [BKV, G];
//   part            given each head's maximum and total over the whole ring
//                   (float2 [BKV, G]), the block's T(exp(s - max) / total)
//                   weighting its values, summed in float32, o [BKV, G, HD]
//                   float32;
// so a cache held in blocks (``models/attention.py:_split_softmax``) is
// one stats launch a block, their combine, and one part launch a block.
//
// Bound on this card: memory.  Each visible K and V element is read once
// (2 bytes) for 2 G flops, far below the ~20 flops a byte of float32.
//
// Design: a block takes one (sequence, kv head) with 4 warps.  A slot is
// visible where its age (pos - slot) mod S is at most min(pos, window - 1),
// the rule of ``decode_attention``; the visible slots are a contiguous
// run of the ring, and only the run's slots in k and v are read.  The
// position is read on the device (a 0-d int64 tensor, so a captured CUDA
// graph replays at any position) or passed by value.  A row of HD values
// is C = HD / 8 chunks of 8 values (16 bytes in bf16 and fp16, two 16-byte
// loads in float32); a warp takes R = 32 / C consecutive rows at once, a
// lane one chunk, so a warp's loads are contiguous.  The G query heads of
// the block share each K and V row: a lane holds its chunk of every query
// head of a group of GB in registers, and a row's dot products are summed
// over its C lanes by shuffles.  The scores live in shared memory ([G, n]
// float32; in a scratch buffer from the caller where they would not fit,
// as gqa_decode_scratch says), the softmax takes a warp per query head,
// and the weighted values are summed per lane over its rows, then over
// the lanes and warps through shared memory, in a fixed order, so the
// output does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;               // row groups whose loads a warp issues together
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 48 * 1024;    // without opting in to more
constexpr int kWhole = 0, kStats = 1, kPart = 2;

// A lane's chunk of 8 values: kVecs 16-byte words.
template <typename T>
struct Num;

template <>
struct Num<__nv_bfloat16> {
  static constexpr int kVecs = 1;
  static __device__ __forceinline__ void widen(const uint4* raw, float* f) {
    const uint32_t w[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Num<__half> {
  static constexpr int kVecs = 1;
  static __device__ __forceinline__ void widen(const uint4* raw, float* f) {
    const uint32_t w[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ float load(const __half* p) { return __half2float(*p); }
  static __device__ __forceinline__ __half narrow(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

template <>
struct Num<float> {
  static constexpr int kVecs = 2;
  static __device__ __forceinline__ void widen(const uint4* raw, float* f) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      f[4 * j] = __uint_as_float(raw[j].x);
      f[4 * j + 1] = __uint_as_float(raw[j].y);
      f[4 * j + 2] = __uint_as_float(raw[j].z);
      f[4 * j + 3] = __uint_as_float(raw[j].w);
    }
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

// Rows a warp takes at once; the query heads a block scores at once (the
// kernel's template); and the shared floats of the partial outputs (one
// [GB, HD] slice per warp and row) and of the scores.
inline int rows_per_warp(int hd) { return 32 / (hd / 8); }
inline int group_block(int G) { return G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : 8; }
inline long long partial_floats(int G, int hd) {
  return (long long)kWarps * rows_per_warp(hd) * group_block(G) * hd;
}
inline bool scores_in_shared(int G, int hd, int n_max) {
  return 4 * (partial_floats(G, hd) + (long long)G * n_max) <= kMaxShared;
}

template <typename T, int GB>
__global__ void __launch_bounds__(kThreads)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  void* __restrict__ o, float2* __restrict__ stats, float* __restrict__ scratch,
                  const long long* __restrict__ pos_ptr, long long pos_val, int G, int S,
                  int N, int first, int hd, int n_max, float scale, int mode) {
  constexpr int V = Num<T>::kVecs;
  extern __shared__ float smem[];
  const long long bkv = blockIdx.x;
  const int C = hd / 8, R = 32 / C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = lane / C, c = lane % C;
  const bool active = r < R;
  float* part = smem;
  float* sc = scratch ? scratch + bkv * G * n_max : smem + kWarps * R * GB * hd;

  // The visible slots: ages 0 .. n - 1, oldest first from slot s0 of the
  // ring; row i of the run is slot (s0 + i) mod S, held here where it lies
  // in first .. first + N - 1.
  const long long p = pos_ptr ? *pos_ptr : pos_val;
  const int n = (int)(p < n_max - 1 ? p : n_max - 1) + 1;
  const int s0 = (int)((p - (n - 1)) % S);
  const T* kb = k + bkv * N * hd;
  const T* vb = v + bkv * N * hd;
  const T* qb = q + bkv * G * hd;
  int top = 0;                             // the first shuffle offset of a row's sum
  for (int t = 1; t < C; t *= 2) top = t;

  // Row i's slot in k and v, or -1 where this block does not hold it.
  auto local = [&](int i) -> int {
    if (!active || i >= n) return -1;
    int slot = s0 + i;
    if (slot >= S) slot -= S;
    slot -= first;
    return slot >= 0 && slot < N ? slot : -1;
  };
  auto chunk = [&](const T* base, int slot, uint4* raw) {
    if (slot < 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) raw[j] = make_uint4(0, 0, 0, 0);
      return;
    }
    const uint4* at = reinterpret_cast<const uint4*>(base + (long long)slot * hd) + c * V;
#pragma unroll
    for (int j = 0; j < V; ++j) raw[j] = __ldg(at + j);
  };

  // Scores: a group of GB query heads at a time over every visible K row
  // (-inf for a row of the run that another block holds).
  for (int g0 = 0; g0 < G; g0 += GB) {
    const int ng = min(GB, G - g0);
    float qr[GB][8];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qr[g][e] = (active && g < ng) ? Num<T>::load(qb + (g0 + g) * hd + c * 8 + e) : 0.f;
    for (int grp = warp; grp * R < n; grp += kWarps * kUnroll) {
      uint4 raw[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) chunk(kb, local((grp + u * kWarps) * R + r), raw[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = (grp + u * kWarps) * R + r;
        float kf[8], dot[GB];
        Num<T>::widen(raw[u], kf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          dot[g] = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[g] = fmaf(qr[g][e], kf[e], dot[g]);
        }
        // Sum over the row's C lanes (c = 0 .. C - 1): a tree of shuffles,
        // each adding only from a lane of the same row.
        for (int off = top; off > 0; off /= 2) {
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float other = __shfl_down_sync(kFull, dot[g], off);
            if (c + off < C) dot[g] += other;
          }
        }
        if (active && c == 0 && i < n) {
          const bool held = local(i) >= 0;
#pragma unroll
          for (int g = 0; g < GB; ++g)
            if (g < ng)
              sc[(long long)(g0 + g) * n_max + i] =
                  held ? dot[g] * scale : __int_as_float(0xff800000);
        }
      }
    }
  }
  __syncthreads();

  // Softmax: a warp a query head.  The stats mode ends here.
  for (int g = warp; g < G; g += kWarps) {
    float* row = sc + (long long)g * n_max;
    float m, sum;
    if (mode == kPart) {
      const float2 mt = stats[bkv * G + g];
      m = mt.x;
      sum = mt.y;
    } else {
      m = __int_as_float(0xff800000);   // -inf
      for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      sum = 0.f;
      if (m != __int_as_float(0xff800000))
        for (int i = lane; i < n; i += 32) {
          const float e = expf(row[i] - m);
          row[i] = e;
          sum += e;
        }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(kFull, sum, off);
    }
    if (mode == kStats) {
      if (lane == 0) stats[bkv * G + g] = make_float2(m, sum);
    } else {
      for (int i = lane; i < n; i += 32)
        row[i] = Num<T>::round((mode == kPart ? expf(row[i] - m) : row[i]) / sum);
    }
  }
  if (mode == kStats) return;
  __syncthreads();

  // Output: each lane sums its chunk of its rows of V, weighted, for a
  // group of GB query heads; then the lanes' and warps' sums in order.
  for (int g0 = 0; g0 < G; g0 += GB) {
    const int ng = min(GB, G - g0);
    float acc[GB][8];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    for (int grp = warp; grp * R < n; grp += kWarps * kUnroll) {
      uint4 raw[kUnroll][V];
      int slot[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        slot[u] = local((grp + u * kWarps) * R + r);
        chunk(vb, slot[u], raw[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (slot[u] < 0) continue;
        const int i = (grp + u * kWarps) * R + r;
        float vf[8];
        Num<T>::widen(raw[u], vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g >= ng) continue;
          const float w = sc[(long long)(g0 + g) * n_max + i];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part[((warp * R + r) * GB + g) * hd + c * 8 + e] = acc[g][e];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < ng * hd; j += kThreads) {
      const int g = j / hd, d = j % hd;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w)
        for (int rr = 0; rr < R; ++rr) s += part[((w * R + rr) * GB + g) * hd + d];
      const long long at = (bkv * G + g0 + g) * hd + d;
      if (mode == kPart)
        static_cast<float*>(o)[at] = s;
      else
        static_cast<T*>(o)[at] = Num<T>::narrow(s);
    }
    __syncthreads();                       // part is written anew by the next group
  }
}

template <typename T, int GB>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float2* stats,
                   float* scratch, const long long* pos_ptr, long long pos_val, int bkv, int G,
                   int S, int N, int first, int hd, int n_max, float scale, int mode,
                   cudaStream_t stream) {
  const long long floats = partial_floats(G, hd) + (scratch ? 0 : (long long)G * n_max);
  if (floats * 4 > kMaxShared) return cudaErrorInvalidValue;
  gqa_decode_kernel<T, GB><<<bkv, kThreads, floats * 4, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, stats,
      scratch, pos_ptr, pos_val, G, S, N, first, hd, n_max, scale, mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float2* stats,
                     float* scratch, const long long* pos_ptr, long long pos_val, int bkv, int G,
                     int S, int N, int first, int hd, int n_max, float scale, int mode,
                     cudaStream_t stream) {
  switch (group_block(G)) {
    case 1:
      return launch<T, 1>(q, k, v, o, stats, scratch, pos_ptr, pos_val, bkv, G, S, N, first, hd,
                          n_max, scale, mode, stream);
    case 2:
      return launch<T, 2>(q, k, v, o, stats, scratch, pos_ptr, pos_val, bkv, G, S, N, first, hd,
                          n_max, scale, mode, stream);
    case 4:
      return launch<T, 4>(q, k, v, o, stats, scratch, pos_ptr, pos_val, bkv, G, S, N, first, hd,
                          n_max, scale, mode, stream);
    default:
      return launch<T, 8>(q, k, v, o, stats, scratch, pos_ptr, pos_val, bkv, G, S, N, first, hd,
                          n_max, scale, mode, stream);
  }
}

}  // namespace

// The float32 scratch a (sequence, kv head) needs for its scores: 0 where
// they fit in shared memory beside the partial outputs, else G * n_max.
extern "C" int gqa_decode_scratch(int G, int hd, int n_max) {
  if (hd < 8 || hd > 256 || hd % 8 || G < 1 || n_max < 1) return -1;
  return scores_in_shared(G, hd, n_max) ? 0 : G * n_max;
}

// dtype 0: bf16, 1: fp16, 2: float32.  mode 0: whole, 1: stats, 2: part
// (see above); stats float2 [bkv, G], written by mode 1 and read by mode 2.
// k and v hold slots first .. first + N - 1 of a ring of S.  pos_ptr a
// device int64, or null and pos_val the position.  n_max = min(S, window),
// the most slots that can be visible.  scratch: null, or bkv times
// gqa_decode_scratch floats where that is not 0.
extern "C" int gqa_decode(const void* q, const void* k, const void* v, void* o, void* stats,
                          void* scratch, const void* pos_ptr, long long pos_val, int bkv, int G,
                          int S, int N, int first, int hd, int n_max, float scale, int dtype,
                          int mode, void* stream) {
  if (hd < 8 || hd > 256 || hd % 8 || G < 1 || S < 1 || N < 1 || first < 0 || first + N > S
      || n_max < 1 || n_max > S || bkv < 0 || mode < kWhole || mode > kPart
      || (mode == kWhole && (first != 0 || N != S)) || (mode != kWhole && !stats)
      || (!scratch && !scores_in_shared(G, hd, n_max)))
    return (int)cudaErrorInvalidValue;
  if (bkv == 0) return 0;
  float2* st = static_cast<float2*>(stats);
  float* sc = static_cast<float*>(scratch);
  const long long* pp = static_cast<const long long*>(pos_ptr);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<__nv_bfloat16>(q, k, v, o, st, sc, pp, pos_val, bkv, G, S, N, first,
                                          hd, n_max, scale, mode, stream_);
    case 1:
      return (int)dispatch<__half>(q, k, v, o, st, sc, pp, pos_val, bkv, G, S, N, first, hd,
                                   n_max, scale, mode, stream_);
    case 2:
      return (int)dispatch<float>(q, k, v, o, st, sc, pp, pos_val, bkv, G, S, N, first, hd,
                                  n_max, scale, mode, stream_);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
