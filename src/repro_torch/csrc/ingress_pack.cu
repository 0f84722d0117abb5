// Booleanized images -> packed patch literals, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ingress.py:ingress_pack_pallas
// (body ingress_pack_kernel).  Same function: for each image and patch,
// gather the Wy x Wx window in (wy, wx) order, append the y- and
// x-position thermometer bits, form the literals [x, 1 - x], zero-pad to
// whole 32-bit words and pack LSB-first.  Z = U = 1 geometries only.
//
// Bound on this card: bytes.  The kernel reads Y*X bytes of an image and
// writes P*W words; at the paper's geometry (28x28, P=361, W=9) that is
// 784 B in and 12,996 B out per image, against a few integer operations
// per output bit.  The design keeps the dense literal bits out of device
// memory altogether.  A block covers one image's next kWordsPerBlock
// output words (13 blocks per paper-size image), so even one image
// spreads over many SMs.  It stages the image in shared memory, with a
// table that maps each literal bit of a patch to its source (a pixel
// offset, a thermometer bit, or a pad bit; negated or not), so the inner
// loop does no division; each thread then builds one output word in
// registers, bit by bit, and stores it once; neighbouring threads store
// neighbouring words, so the only large stream, the output, is written
// coalesced.
//
// Plain C interface (no PyTorch headers); the Python wrapper in
// kernels/ingress.py checks shapes, types and devices and passes raw
// pointers and the current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geom {
  int Y, X;      // image rows, columns
  int Wx;        // window columns
  int dy, dx;    // strides
  int Bx;        // patches per row
  int P;         // patches
  int n_win;     // Wy * Wx window features
  int n_pos_y;   // Y - Wy y-thermometer bits
  int o;         // features
  int n_lit;     // 2o literals
  int W;         // words per patch
};

// Literal codes, one int per literal bit of a patch (pad bits included):
// bits 28-29 the kind, bit 30 the negation, the rest a value.
constexpr int kWindow = 0;   // value: pixel offset wy * X + wx from the patch origin
constexpr int kPosY = 1;     // value: j; y-thermometer bit j is set iff j < py
constexpr int kPosX = 2;     // value: j; x-thermometer bit j is set iff j < px
constexpr int kPad = 3;      // a zero pad bit
constexpr int kNeg = 1 << 30;

constexpr int kWordsPerBlock = 256;   // one output word per thread

__device__ __forceinline__ int literal_code(const Geom& g, int l) {
  if (l >= g.n_lit) return kPad << 28;
  const int neg = l >= g.o ? kNeg : 0;
  int f = l >= g.o ? l - g.o : l;
  if (f < g.n_win) {
    const int wy = f / g.Wx;
    return neg | (wy * g.X + (f - wy * g.Wx));
  }
  f -= g.n_win;
  if (f < g.n_pos_y) return neg | (kPosY << 28) | f;
  return neg | (kPosX << 28) | (f - g.n_pos_y);
}

__global__ void ingress_pack_kernel(const uint8_t* __restrict__ images,
                                    int32_t* __restrict__ out, Geom g) {
  // Shared memory: the literal-code table [32][W] (bit k of word w at
  // k * W + w, so the threads of a warp, on neighbouring words, read
  // neighbouring entries), then the image.
  extern __shared__ int32_t smem[];
  int32_t* code = smem;
  uint8_t* img = (uint8_t*)(code + 32 * g.W);
  const int npix = g.Y * g.X;
  const uint8_t* src = images + (size_t)blockIdx.x * npix;
  for (int i = threadIdx.x; i < npix; i += blockDim.x) img[i] = src[i];
  for (int i = threadIdx.x; i < 32 * g.W; i += blockDim.x) {
    const int k = i / g.W;
    code[i] = literal_code(g, (i - k * g.W) * 32 + k);
  }
  __syncthreads();

  int32_t* dst = out + (size_t)blockIdx.x * g.P * g.W;
  const int i = blockIdx.y * kWordsPerBlock + threadIdx.x;
  if (i < g.P * g.W) {
    const int p = i / g.W;
    const int w = i - p * g.W;
    const int py = p / g.Bx;
    const int px = p - py * g.Bx;
    const uint8_t* patch = img + py * g.dy * g.X + px * g.dx;
    uint32_t word = 0;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const int c = code[k * g.W + w];
      const int v = c & 0x0FFFFFFF;
      uint32_t bit;
      switch ((c >> 28) & 3) {
        case kWindow: bit = patch[v] != 0; break;
        case kPosY: bit = v < py; break;
        case kPosX: bit = v < px; break;
        default: bit = 0; break;
      }
      word |= (bit ^ (uint32_t)((c >> 30) & 1)) << k;
    }
    dst[i] = (int32_t)word;
  }
}

}  // namespace

// images: uint8 0/1 [B, Y, X]; out: int32 [B, P, W].  Returns cudaGetLastError().
extern "C" int ingress_pack(const void* images, void* out, int B, int Y, int X,
                            int Wy, int Wx, int dy, int dx, void* stream) {
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
  const int smem = 32 * g.W * (int)sizeof(int32_t) + Y * X;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ingress_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, (g.P * g.W + kWordsPerBlock - 1) / kWordsPerBlock);
  ingress_pack_kernel<<<grid, kWordsPerBlock, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)images, (int32_t*)out, g);
  return (int)cudaGetLastError();
}
