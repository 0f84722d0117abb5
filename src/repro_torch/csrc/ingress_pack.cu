// Booleanized images -> packed patch literals, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ingress.py:ingress_pack_pallas
// (body ingress_pack_kernel).  Same function: for each image and patch,
// gather the Wy x Wx window in (wy, wx) order, append the y- and
// x-position thermometer bits, form the literals [x, 1 - x], zero-pad to
// whole 32-bit words and pack LSB-first.  Z = U = 1 geometries only.
//
// Bound on this card: bytes.  The kernel reads Y*X bytes of an image and
// writes P*W words: 784 B in and 12,996 B out per image at the paper's
// geometry (28x28, P=361, W=9), 3.5 MB at B=256, about 1.05 us at
// 3.35 TB/s.  The operation floor is one integer operation per output
// word (832k at B=256, 0.05 us at 64 results per clock per SM).
//
// Design: a patch's 2o literals are a short sequence of contiguous bit
// runs, so a word is assembled from runs, not from bits.  In literal
// order the runs are
//   * Wy window runs of Wx bits: run wy is image row py*dy + wy from
//     column px*dx;
//   * the y-thermometer run (bit j set iff j < py) and the x-thermometer
//     run (bit j set iff j < px);
//   * the same o bits again, complemented, from bit o;
//   * zero padding up to W*32.
// One block (1024 threads) owns one image.  It packs the image's rows
// once into bitmasks in shared memory (one __ballot_sync per 32 columns;
// a row wider than 32 columns takes several words, plus one zero word so
// that a funnel shift may read past the row's end).  Lanes then take
// patches and the loop takes words: word w of any patch covers the same
// runs at the same offsets, so the run walk (which run, how many bits,
// complemented or not) is warp-uniform, and one walk serves the 4
// patches a lane assembles at once (lane + 32 q); only the row, column
// and thermometer value differ per patch.  A window chunk is one
// __funnelshift_r of two row words; a thermometer chunk is one mask of
// clamp(q - j, 0, len) low bits; a word takes the few chunks that
// overlap it (four at the paper's geometry), with no per-bit loop, no
// literal-code table and no per-word switch over literal kinds.  The
// divisions by Bx, Wx and W are multiplies by reciprocals set on the
// host.  Words are assembled into a [patches, W] tile in shared memory
// and copied out by neighbouring threads to neighbouring addresses, so
// the output stream, the only large one, is written coalesced.  An image
// whose words exceed the tile (more than kTileWords) is done in chunks of
// whole patches, one tile pass each.
//
// Two booleanize modes, a compile-time parameter of the kernel's body
// (pack_image), each its own kernel:
//   * NonzeroBits (ingress_pack_kernel, entry ingress_pack): the images
//     are booleanized already (uint8 0/1, threshold or none); a pixel's
//     bit is pixel != 0.
//   * AdaptiveGaussian (ingress_pack_kernel_adaptive, entry
//     ingress_pack_adaptive): the images are raw uint8 pixels, booleanized
//     in the kernel as core/booleanize.py:adaptive_gaussian_booleanize
//     does: pixel -> 1 iff pixel > local_mean - c, the local mean a
//     separable Gaussian of `taps` taps with edge replication, along Y
//     first, then along X.  The block stages the image as float32 in
//     shared memory, runs the Y pass into a second float32 plane, and
//     computes the X pass of each pixel where its bit is balloted.  Edge
//     replication is a clamped index.  The mean is bit for bit the plain
//     version's: every product is __fmul_rn, every sum __fadd_rn and every
//     chained 16-block step __fmaf_rn, in _window_sum's order (window_sum
//     below), so nvcc has nothing to contract.  The taps (float32,
//     gaussian_kernel1d) and c ride by value in the kernel's parameters.
//     The float work, 2 x (taps products + taps - 1 sums) a pixel (33k a
//     paper-size image at 11 taps, 0.13 us at B=256 on 67 TFLOP/s), stays
//     below the bytes bound; the bytes are B*Y*X raw pixels in place of
//     B*Y*X bits.
//
// Plain C interface (no PyTorch headers); the Python wrapper in
// kernels/ingress.py checks shapes, types and devices and passes raw
// pointers and the current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// n / d for n * d < 2^32, by a multiply: m = floor(2^32 / d) + 1, and
// d == 1 (whose m overflows 32 bits) adds n itself.
struct FastDiv {
  uint32_t m;
  uint32_t one;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(__umulhi((uint32_t)n, m) + (one ? (uint32_t)n : 0u));
  }
};

inline FastDiv fast_div(int d) {
  return FastDiv{(uint32_t)((1ull << 32) / (uint64_t)d + 1), d == 1 ? 1u : 0u};
}

struct Geom {
  int Y, X;      // image rows, columns
  int Wx;        // window columns
  int dy, dx;    // strides
  int P;         // patches
  int n_win;     // Wy * Wx window features
  int n_pos_y;   // Y - Wy y-thermometer bits
  int o;         // features
  int n_lit;     // 2o literals
  int W;         // words per patch
  int RS;        // words per packed row: ceil(X / 32) + 1 zero word
  int chunk;     // patches per pass over the shared output tile
  int Bx;        // patches per row
  FastDiv by_Bx, by_Wx, by_W;
};

constexpr int kThreads = 1024;
constexpr int kPatchesPerLane = 4;     // one run walk serves 4 patches of a lane
constexpr int kPatchesPerTask = 32 * kPatchesPerLane;
// Words of the shared output tile (48 KB): a whole paper-size image.  The
// wrapper (kernels/ingress.py, TILE_WORDS) sizes the launch's shared
// memory with the same chunk rule.
constexpr int kTileWords = 12288;

__device__ __forceinline__ uint32_t low_bits(int n) {   // n in [0, 32]
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// Bits mode: the images hold booleanized 0/1 pixels.
struct NonzeroBits {
  static constexpr int kFloatPlanes = 0;    // [Y, X] float32 planes in shared memory
  __device__ __forceinline__ void stage(const uint8_t*, float*, const Geom&) const {}
  __device__ __forceinline__ bool bit(const uint8_t* img, const float*, const Geom& g, int r,
                                      int col) const {
    return img[r * g.X + col] != 0;
  }
};

// Taps the launch's parameters hold (kernels/ingress.py, MAX_TAPS).
constexpr int kMaxTaps = 63;

__device__ __forceinline__ float reduce8(const float* p) {
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[4], p[5])),
                   __fadd_rn(__fadd_rn(p[2], p[3]), __fadd_rn(p[6], p[7])));
}

// Adaptive mode: the images hold raw pixels.
struct AdaptiveGaussian {
  static constexpr int kFloatPlanes = 2;    // the pixels, then the Y pass
  int taps;                                 // odd, at most kMaxTaps
  float c;
  float k[kMaxTaps];

  // sum_j v[clamp(i - taps / 2 + j) * stride] * k[j] over a line of n
  // values, rounded as core/booleanize.py:_window_sum rounds: the first
  // taps / 16 * 16 taps in 8 lanes (products, then fused multiply-adds
  // chained per lane, then reduce8), then one block each of 8 (reduce8), 4
  // ((p0 + p1) + (p2 + p3)), 2 and 1, each block's sum added to the
  // running total in that order.
  __device__ float window_sum(const float* v, int stride, int i, int n) const {
    const int first = i - taps / 2;
    auto at = [&](int j) { return v[min(max(first + j, 0), n - 1) * stride]; };
    auto prod = [&](int j) { return __fmul_rn(at(j), k[j]); };
    float total = 0.0f;
    bool started = false;
    auto add = [&](float part) {
      total = started ? __fadd_rn(total, part) : part;
      started = true;
    };
    int j = 0;
    const int n16 = taps / 16 * 16;
    if (n16) {
      float lane[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) lane[l] = prod(l);
      for (j = 8; j < n16; j += 8) {
#pragma unroll
        for (int l = 0; l < 8; ++l) lane[l] = __fmaf_rn(at(j + l), k[j + l], lane[l]);
      }
      add(reduce8(lane));
    }
    if (taps - j >= 8) {
      float p[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) p[l] = prod(j + l);
      add(reduce8(p));
      j += 8;
    }
    if (taps - j >= 4) {
      add(__fadd_rn(__fadd_rn(prod(j), prod(j + 1)), __fadd_rn(prod(j + 2), prod(j + 3))));
      j += 4;
    }
    if (taps - j >= 2) {
      add(__fadd_rn(prod(j), prod(j + 1)));
      j += 2;
    }
    if (taps - j >= 1) add(prod(j));
    return total;
  }

  // planes: [Y, X] pixels as float32, then [Y, X] the Y pass.  Warps take
  // rows, lanes columns.
  __device__ void stage(const uint8_t* img, float* planes, const Geom& g) const {
    float* down = planes + g.Y * g.X;
    for (int i = threadIdx.x; i < g.Y * g.X; i += blockDim.x) planes[i] = (float)img[i];
    __syncthreads();
    for (int r = threadIdx.x >> 5; r < g.Y; r += blockDim.x >> 5)
      for (int col = threadIdx.x & 31; col < g.X; col += 32)
        down[r * g.X + col] = window_sum(planes + col, g.X, r, g.Y);
    __syncthreads();
  }

  __device__ __forceinline__ bool bit(const uint8_t*, const float* planes, const Geom& g,
                                      int r, int col) const {
    const float mean = window_sum(planes + g.Y * g.X + r * g.X, 1, col, g.X);
    return planes[r * g.X + col] > __fsub_rn(mean, c);
  }
};

template <class Mode>
__device__ __forceinline__ void pack_image(const uint8_t* __restrict__ images,
                                           int32_t* __restrict__ out, const Geom& g,
                                           const Mode& mode) {
  extern __shared__ uint32_t smem[];
  uint32_t* rows = smem;                      // [Y, RS] row bitmasks
  uint32_t* tile = smem + g.Y * g.RS;         // [chunk, W] output words
  float* planes = reinterpret_cast<float*>(tile + g.chunk * g.W);   // Mode::kFloatPlanes x [Y, X]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row_words = g.RS - 1;
  const uint8_t* img = images + (size_t)blockIdx.x * g.Y * g.X;

  mode.stage(img, planes, g);
  // Row bitmasks: bit k of word j of row r is pixel (r, 32 j + k).
  for (int t = warp; t < g.Y * row_words; t += nwarps) {
    const int r = t / row_words;
    const int col = (t - r * row_words) * 32 + lane;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, col < g.X && mode.bit(img, planes, g, r, col));
    if (lane == 0) rows[r * g.RS + (col >> 5)] = bits;
  }
  for (int r = threadIdx.x; r < g.Y; r += blockDim.x) rows[r * g.RS + row_words] = 0;
  __syncthreads();

  int32_t* dst = out + (size_t)blockIdx.x * g.P * g.W;
  const int tasks_w = (g.chunk + kPatchesPerTask - 1) / kPatchesPerTask;
  for (int p0 = 0; p0 < g.P; p0 += g.chunk) {
    const int pc = min(g.chunk, g.P - p0);
    // Task t: word w of patches base + lane + 32 q (lanes take patches).
    for (int t = warp; t < tasks_w * g.W; t += nwarps) {
      const int tq = g.by_W(t);
      const int w = t - tq * g.W;
      const int base = tq * kPatchesPerTask;
      int py[kPatchesPerLane], px[kPatchesPerLane];
      const uint32_t* row0[kPatchesPerLane];
#pragma unroll
      for (int q = 0; q < kPatchesPerLane; ++q) {
        const int p = p0 + min(base + lane + 32 * q, pc - 1);   // past the chunk: its last patch
        py[q] = g.by_Bx(p);
        px[q] = p - py[q] * g.Bx;
        row0[q] = rows + py[q] * g.dy * g.RS;
      }

      uint32_t word[kPatchesPerLane] = {};
      const int lbase = w * 32;
      const int lend = min(lbase + 32, g.n_lit);
      for (int l = lbase; l < lend;) {       // one chunk of one run per step (warp-uniform)
        const bool neg = l >= g.o;
        const int f = neg ? l - g.o : l;
        const uint32_t flip = neg ? 0xffffffffu : 0u;
        const int sh = l - lbase;
        if (f < g.n_win) {                   // window run wy, from column off
          const int wy = g.by_Wx(f);
          const int off = f - wy * g.Wx;
          const int len = min(g.Wx - off, lend - l);
          const uint32_t mask = low_bits(len);
#pragma unroll
          for (int q = 0; q < kPatchesPerLane; ++q) {
            const int col = px[q] * g.dx + off;
            const uint32_t* row = row0[q] + wy * g.RS + (col >> 5);
            word[q] |= ((__funnelshift_r(row[0], row[1], col & 31) ^ flip) & mask) << sh;
          }
          l += len;
        } else {                             // a thermometer run: bits j... set iff j < pos
          const bool is_y = f < g.n_win + g.n_pos_y;
          const int j = is_y ? f - g.n_win : f - g.n_win - g.n_pos_y;
          const int len = min(is_y ? g.n_win + g.n_pos_y - f : g.o - f, lend - l);
          const uint32_t mask = low_bits(len);
#pragma unroll
          for (int q = 0; q < kPatchesPerLane; ++q) {
            const int pos = is_y ? py[q] : px[q];
            word[q] |= ((low_bits(min(max(pos - j, 0), 32)) ^ flip) & mask) << sh;
          }
          l += len;
        }
      }
#pragma unroll
      for (int q = 0; q < kPatchesPerLane; ++q) {
        const int pl = base + lane + 32 * q;
        if (pl < pc) tile[pl * g.W + w] = word[q];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < pc * g.W; i += blockDim.x)
      dst[(size_t)p0 * g.W + i] = (int32_t)tile[i];
    __syncthreads();                         // the tile is free for the next chunk
  }
}

// Bits mode: 32 registers, so two blocks of 1024 threads share an SM.
__global__ void __launch_bounds__(kThreads)
ingress_pack_kernel(const uint8_t* __restrict__ images, int32_t* __restrict__ out, Geom g) {
  pack_image(images, out, g, NonzeroBits{});
}

// Adaptive mode: held to the same two blocks an SM (unbounded it takes 48
// registers and one block an SM: 0.01134 against 0.01044 ms on an H100 at
// B=256, the paper's geometry).
__global__ void __launch_bounds__(kThreads, 2)
ingress_pack_kernel_adaptive(const uint8_t* __restrict__ images, int32_t* __restrict__ out,
                             Geom g, const __grid_constant__ AdaptiveGaussian mode) {
  pack_image(images, out, g, mode);
}

Geom make_geom(int Y, int X, int Wy, int Wx, int dy, int dx) {
  Geom g;
  g.Y = Y;
  g.X = X;
  g.Wx = Wx;
  g.dy = dy;
  g.dx = dx;
  g.Bx = 1 + (X - Wx) / dx;
  g.P = g.Bx * (1 + (Y - Wy) / dy);
  g.n_win = Wy * Wx;
  g.n_pos_y = Y - Wy;
  g.o = g.n_win + (Y - Wy) + (X - Wx);
  g.n_lit = 2 * g.o;
  g.W = (g.n_lit + 31) / 32;
  g.RS = (X + 31) / 32 + 1;
  g.chunk = g.P * g.W <= kTileWords ? g.P : (kTileWords / g.W > 0 ? kTileWords / g.W : 1);
  g.by_Bx = fast_div(g.Bx);
  g.by_Wx = fast_div(Wx);
  g.by_W = fast_div(g.W);
  return g;
}

// Shared memory: the row bitmasks, the output tile and the mode's float32
// planes (kernels/ingress.py, shared_bytes, follows the same rule).
template <class Mode, class Kernel, class... Params>
int launch(Kernel kernel, const void* images, void* out, int B, const Geom& g, void* stream,
           const Params&... params) {
  const int smem = (g.Y * g.RS + g.chunk * g.W + Mode::kFloatPlanes * g.Y * g.X) *
                   (int)sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>((const uint8_t*)images, (int32_t*)out, g,
                                                     params...);
  return (int)cudaGetLastError();
}

}  // namespace

// images: uint8 0/1 [B, Y, X]; out: int32 [B, P, W].  Returns cudaGetLastError().
extern "C" int ingress_pack(const void* images, void* out, int B, int Y, int X,
                            int Wy, int Wx, int dy, int dx, void* stream) {
  return launch<NonzeroBits>(ingress_pack_kernel, images, out, B,
                             make_geom(Y, X, Wy, Wx, dy, dx), stream);
}

// images: raw uint8 [B, Y, X]; taps: block_size float32 values on the host
// (copied into the launch's parameters); out: int32 [B, P, W].  Returns
// cudaErrorInvalidValue for an even block_size or one past kMaxTaps, else
// cudaGetLastError().
extern "C" int ingress_pack_adaptive(const void* images, void* out, int B, int Y, int X,
                                     int Wy, int Wx, int dy, int dx, int block_size,
                                     const float* taps, float c, void* stream) {
  if (block_size < 1 || block_size > kMaxTaps || block_size % 2 == 0)
    return (int)cudaErrorInvalidValue;
  AdaptiveGaussian mode{};
  mode.taps = block_size;
  mode.c = c;
  for (int j = 0; j < block_size; ++j) mode.k[j] = taps[j];
  return launch<AdaptiveGaussian>(ingress_pack_kernel_adaptive, images, out, B,
                                  make_geom(Y, X, Wy, Wx, dy, dx), stream, mode);
}
