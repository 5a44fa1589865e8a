// The im2col plane of a small-channel conv (sm_90a): the staging kernel
// of route `sm90_im2col`, both of the conv (K1) and of its weight
// gradient (K2).
//
//   plane[b, oy, ox, (ky*Wk + kx)*Ci + ci] =
//       x[b, oy + ky*dly - py, ox + kx*dlx - px, ci]
//
// (zero outside the plane, and in channels K = Hk*Wk*Ci ... Cp - 1).
// With it, dW = plane^T dy is a 1x1 weight gradient of Cp input
// channels, which the tensor-core kernels take (csrc/wgrad_lb_sm90.cu in
// bf16, csrc/wgrad_lb_sm90_tf32.cu in f32); rows 0 .. K-1 of its dW are
// dW (Hk, Wk, Ci, Co) in HWIO order.  Likewise the conv is a 1x1 conv of
// the plane against w (Hk, Wk, Ci, Co) read as K rows (csrc/
// conv_lb_sm90.cu in bf16, its weight map zero past row K).
//
// Replaces, with those kernels, the TPU kernels `_wgrad_kernel` launched
// by `wgrad_lb_call` (src/repro/kernels/conv_lb/wgrad.py:50, :94) and
// `_conv_kernel` launched by `conv_lb_call` (src/repro/kernels/conv_lb/
// kernel.py:116, :177) where Ci is too small for a TMA map: VGG16's
// conv1_1 has Ci = 3, a 6-byte bf16 pixel that no TMA stride describes,
// and on FMA its wgrad read dy at 1/30 of the HBM rate.
//
// What bounds it on this card: bytes.  It reads x (B*H*W*Ci words, each
// Hk*Wk times, from L1 and L2) and writes the plane (B*Ho*Wo*Cp words):
// 2.4 MB against 25.7 MB in bf16 at VGG16's conv1_1, batch 8.
//
// What the design does about it: one thread per 16-byte chunk of a
// plane pixel (8 bf16 or 4 f32 channels), so that a warp stores 512
// consecutive bytes; `rb` blocks per output row, every row of every image
// folded into the grid's x dimension (blockIdx.x = (b * Ho + oy) * rb +
// block of the row: up to 2^31 - 1 blocks, so any batch and height whose
// plane fits); the block's row, image and output row divided out once, by
// its first thread, beside the taps, so a thread's own indices are one
// 32-bit division by the chunks of a pixel (a first build divided a
// 64-bit flat index three times a chunk and ran at a seventh of the HBM
// rate); the channel's tap and input channel stepped, not divided; the
// taps (ky*dly - py, kx*dlx - px) from the wrapper, staged in shared
// memory, so padding and dilation are only offsets; x read through the
// read-only cache, where the Hk*Wk taps of neighbouring pixels meet.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 64;  // plane channels: Cp <= 64

struct Taps {
  int B, H, W, Ci, Ho, Wo;
  int rb;                // blocks per output row
  int K;                 // Hk * Wk * Ci real channels
  int Cp;                // plane channels (a multiple of 8, K <= Cp <= 64)
  int ty[kMaxTaps];      // window ky*Wk + kx -> row offset ky*dly - py
  int tx[kMaxTaps];      // ... and column offset kx*dlx - px
};

// T: the words' bits (uint32_t for f32, uint16_t for bf16): the plane is
// a copy, and zero bits are +0 in both types
template <typename T>
__global__ void __launch_bounds__(256)
wgrad_im2col_kernel(const T* __restrict__ x, uint4* __restrict__ out,
                    const __grid_constant__ Taps p) {
  constexpr int kPer = 16 / sizeof(T);  // channels of one 16-byte chunk
  __shared__ int ty[kMaxTaps], tx[kMaxTaps];
  __shared__ int at[3];  // this block's output row b * Ho + oy, b, oy
  for (int i = threadIdx.x; i < kMaxTaps; i += blockDim.x) {
    ty[i] = p.ty[i];
    tx[i] = p.tx[i];
  }
  if (threadIdx.x == 0) {  // the block's divisions, once
    const int row = blockIdx.x / p.rb, b = row / p.Ho;
    at[0] = row;
    at[1] = b;
    at[2] = row - b * p.Ho;
  }
  __syncthreads();
  const int chunks = p.Cp / kPer;
  const int row = at[0], b = at[1], oy = at[2];
  const int i = (blockIdx.x - row * p.rb) * blockDim.x + threadIdx.x;
  if (i >= p.Wo * chunks) return;                       // (ox, chunk)
  const int ox = i / chunks;
  const int c0 = (i - ox * chunks) * kPer;
  int tap = c0 / p.Ci, ci = c0 - tap * p.Ci;
  const T* xb = x + static_cast<size_t>(b) * p.H * p.W * p.Ci;
  alignas(16) T v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    T val = 0;
    if (c0 + e < p.K) {
      const int iy = oy + ty[tap], ix = ox + tx[tap];
      if (static_cast<unsigned>(iy) < static_cast<unsigned>(p.H) &&
          static_cast<unsigned>(ix) < static_cast<unsigned>(p.W))
        val = __ldg(xb + (iy * p.W + ix) * p.Ci + ci);
    }
    v[e] = val;
    if (++ci == p.Ci) {
      ci = 0;
      ++tap;
    }
  }
  out[static_cast<size_t>(row) * p.Wo * chunks + i] =
      *reinterpret_cast<const uint4*>(v);
}

}  // namespace

// plane (B, Ho, Wo, Cp) from x (B, H, W, Ci), both contiguous, of type
// dtype (0 f32, 1 bf16), the plane 16-byte aligned; taps: ntaps pairs
// (row offset, column offset) in host memory, ntaps * Ci <= Cp <= 64,
// Cp a multiple of 8; one image of x and one plane row under 2^31 words,
// and the grid's B * Ho * ceil(Wo * Cp * size / 16 / 256) blocks at most
// 2^31 - 1 (the wrapper's `stage_fits` checks the same).  Returns a CUDA
// error code.
extern "C" int wgrad_im2col_forward(const void* x, void* plane,
                                    const void* taps, int B, int H, int W,
                                    int Ci, int Ho, int Wo, int ntaps,
                                    int Cp, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Ci < 1 || Ho < 1 || Wo < 1 || ntaps < 1 ||
      Cp % 8 || Cp > kMaxTaps || ntaps * Ci > Cp || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(plane) % 16 ||
      static_cast<long long>(H) * W * Ci >= (1ll << 31) ||
      static_cast<long long>(Wo) * Cp >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_chunks =
      static_cast<long long>(Wo) * Cp * (dtype == 0 ? 4 : 2) / 16;
  const long long rb = (row_chunks + 255) / 256;
  const long long blocks = rb * Ho * B;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  Taps p;
  p.B = B; p.H = H; p.W = W; p.Ci = Ci; p.Ho = Ho; p.Wo = Wo;
  p.rb = static_cast<int>(rb);
  p.K = ntaps * Ci;
  p.Cp = Cp;
  const int* t = static_cast<const int*>(taps);
  for (int i = 0; i < kMaxTaps; ++i) {
    p.ty[i] = i < ntaps ? t[2 * i] : 0;
    p.tx[i] = i < ntaps ? t[2 * i + 1] : 0;
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* out = static_cast<uint4*>(plane);
  if (dtype == 0)
    wgrad_im2col_kernel<uint32_t><<<grid, 256, 0, s>>>(
        static_cast<const uint32_t*>(x), out, p);
  else
    wgrad_im2col_kernel<uint16_t><<<grid, 256, 0, s>>>(
        static_cast<const uint16_t*>(x), out, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgrad_im2col_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
