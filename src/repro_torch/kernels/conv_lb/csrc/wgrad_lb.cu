// Weight gradient of an NHWC convolution, for Hopper (sm_90a):
//
//   dW[ky, kx, ci, co] = sum_{b, oy, ox}
//       x[b, oy*sy + ky*dy - py, ox*sx + kx*dx - px, ci] * g[b, oy, ox, co]
//
// (x read as zero outside the plane.)  Replaces the TPU kernel
// `_wgrad_kernel` launched by `wgrad_lb_call`
// (src/repro/kernels/conv_lb/wgrad.py:50).  It computes the same
// function; it is not a block-by-block copy of it.
//
// The product.  dW is a (Hk*Wk*Ci) x Co matrix: row m = (ky, kx, ci),
// column co.  It is the product of an implicit im2col matrix A
// (K x M, K = B*Ho*Wo reduction pixels, A[k][m] = the x word that
// window (ky, kx) reads for output pixel k) and g (K x Co).
//
// What bounds it on this card.  For VGG's 3x3 layers it is f32
// operations: 2*Hk*Wk*Ci*Co FLOP per reduction pixel against
// Ci + Co words read per pixel.  conv1_1 (Ci = 3) does little
// arithmetic per word and is bound by the bytes it reads.
//
// What the design does about it.
//  * The reduction is long and dW is small (VGG conv1_2: 576 x 64
//    words over 401,408 pixels), so a CTA tile of dW alone fills one
//    or two SMs.  The reduction is split into `splits` contiguous
//    ranges of pixels, chosen on the host to fill the card's 132 SMs.
//    Each CTA keeps its 128-row x TN-column dW tile in registers
//    across its whole pixel range (the paper's OutR on the weight
//    gradient) and writes it once, to a workspace slice of its own.
//    A second pass sums the slices in split order, so two runs give
//    the same bits (no atomics).  With one split the CTA writes dW
//    directly and there is no second pass.
//  * Per step of 16 pixels the CTA stages the A tile (gathered from x
//    at the window's offset, 16-byte copies where Ci % 4 == 0) and the
//    g tile in shared memory with cp.async, double-buffered, so the
//    next step's copies run while this one is computed.  Padding, the
//    ragged tail of the reduction and stride come from predicates (a
//    predicated-off copy writes zeros); no padded copy of x is made.
//  * The Hk*Wk windows of one pixel read overlapping x words; tiles
//    of neighbouring rows of dW run side by side (blockIdx.x fastest)
//    on the same pixels, so those re-reads are served by L2, not HBM.
//  * Plain FMA on f32, no tensor cores or TMA yet.
//
// Types.  x and g are f32 or bf16 (one type); dW is f32, as the
// reference's wgrad returns it.  bf16 words are widened to f32 as they
// are staged (plain loads, 8 bytes where 4 channels allow, since
// cp.async cannot widen), so shared memory, the FMA and the sums are
// the f32 kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;   // dW rows (ky, kx, ci) per CTA
constexpr int kChunk = 16;    // reduction pixels staged per step

struct Geom {
  int B, H, W, Ci, Co, Hk, Wk, Ho, Wo;
  int sy, sx, dy, dx, py, px;
  int M;                 // Hk * Wk * Ci
  int K;                 // B * Ho * Wo
  int splits;            // reduction ranges (gridDim.z)
  int chunks_per_split;  // kChunk-pixel steps per range
  int x_vec;             // x 16-byte aligned and Ci % 4 == 0
  int g_vec;             // g 16-byte aligned and Co % 4 == 0
  int o_vec;             // dW / workspace 16-byte aligned, Co % 4 == 0
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// stage 4 consecutive words (vec) or one into f32 shared memory: f32 by
// cp.async, bf16 by plain loads widened to f32 (zeros where !ok)
template <typename T>
__device__ __forceinline__ void stage_words(float* dst, const T* src,
                                            bool ok, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec)
      cp_async16(dst, src, ok);
    else
      cp_async4(dst, src, ok);
  } else if (vec) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const uint2 a = *reinterpret_cast<const uint2*>(src);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
      v = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    *dst = ok ? __bfloat162float(*src) : 0.f;
  }
}

// T: the type of x and g (float or __nv_bfloat16); dW is f32
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_lb_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                float* __restrict__ out, const Geom g) {
  constexpr int NJ = TN / 16;  // dW columns per thread
  __shared__ __align__(16) float s_a[2][kChunk][kTileM];
  __shared__ __align__(16) float s_b[2][kChunk][TN];

  const int tid = threadIdx.x;
  const int tm = tid >> 4;   // rows tm*4 + i and 64 + tm*4 + i
  const int tn = tid & 15;   // cols tn*4 + j (and 64 + tn*4 + j)
  const int m0 = blockIdx.x * kTileM;
  const int co0 = blockIdx.y * TN;
  const int k_begin = blockIdx.z * g.chunks_per_split * kChunk;
  const int k_end = min(g.K, k_begin + g.chunks_per_split * kChunk);
  const int nchunks = (k_end - k_begin + kChunk - 1) / kChunk;
  const int hw = g.Ho * g.Wo;

  // the A column this thread stages: 4 rows of one window (x_vec) or
  // one row, decoded once into the window's x offset and channel
  const int a_col = g.x_vec ? (tid & 31) * 4 : (tid & (kTileM - 1));
  const int a_row0 = g.x_vec ? (tid >> 5) : (tid >> 7);
  const int a_rstep = g.x_vec ? kThreads / 32 : kThreads / kTileM;
  const int am = m0 + a_col;
  const bool a_ok = am < g.M;
  int a_oy = 0, a_ox = 0, a_ci = 0;
  if (a_ok) {
    const int win = am / g.Ci;
    a_ci = am - win * g.Ci;
    const int ky = win / g.Wk;
    a_oy = ky * g.dy - g.py;
    a_ox = (win - ky * g.Wk) * g.dx - g.px;
  }
  const int b_cols = g.g_vec ? TN / 4 : TN;
  const int b_col = (tid % b_cols) * (TN / b_cols);
  const int b_row0 = tid / b_cols;
  const int b_rstep = kThreads / b_cols;
  const bool b_ok = co0 + b_col < g.Co;

  auto stage = [&](int kc, int buf) {
    const int kbase = k_begin + kc * kChunk;
    for (int r = a_row0; r < kChunk; r += a_rstep) {
      const int k = kbase + r;
      const int b = k / hw;
      const int rem = k - b * hw;
      const int oy = rem / g.Wo;
      const int iy = oy * g.sy + a_oy;
      const int ix = (rem - oy * g.Wo) * g.sx + a_ox;
      const bool ok = a_ok && k < k_end && iy >= 0 && iy < g.H &&
                      ix >= 0 && ix < g.W;
      const T* src =
          ok ? x + ((static_cast<size_t>(b) * g.H + iy) * g.W + ix) *
                       g.Ci + a_ci
             : x;
      stage_words(&s_a[buf][r][a_col], src, ok, g.x_vec);
    }
    for (int r = b_row0; r < kChunk; r += b_rstep) {
      const int k = kbase + r;
      const bool ok = b_ok && k < k_end;
      const T* src =
          ok ? gy + static_cast<size_t>(k) * g.Co + co0 + b_col : gy;
      stage_words(&s_b[buf][r][b_col], src, ok, g.g_vec);
    }
  };

  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nchunks) {
      // the other buffer was last read before the previous barrier
      stage(kc + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[buf][k][tm * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s_a[buf][k][64 + tm * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[NJ];
      const float4 b0 = *reinterpret_cast<const float4*>(&s_b[buf][k][tn * 4]);
      bv[0] = b0.x;
      bv[1] = b0.y;
      bv[2] = b0.z;
      bv[3] = b0.w;
      if (NJ == 8) {
        const float4 b1 =
            *reinterpret_cast<const float4*>(&s_b[buf][k][64 + tn * 4]);
        bv[NJ - 4] = b1.x;
        bv[NJ - 3] = b1.y;
        bv[NJ - 2] = b1.z;
        bv[NJ - 1] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // one write of the tile: to dW, or to this split's workspace slice
  float* dst = out + static_cast<size_t>(blockIdx.z) * g.M * g.Co;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + i - 4);
    if (m >= g.M) continue;
#pragma unroll
    for (int q = 0; q < NJ / 4; ++q) {
      const int co = co0 + q * 64 + tn * 4;
      float* row = dst + static_cast<size_t>(m) * g.Co;
      if (g.o_vec) {
        if (co < g.Co)
          *reinterpret_cast<float4*>(row + co) =
              make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                          acc[i][4 * q + 2], acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < g.Co) row[co + j] = acc[i][4 * q + j];
      }
    }
  }
}

// second pass: dW[i] = sum over splits of the workspace, in split order
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws,
                                    float* __restrict__ out, size_t n,
                                    int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) +
                  threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[static_cast<size_t>(p) * n + i];
    out[i] = s;
  }
}

template <typename T, int TN>
cudaError_t launch(const void* x, const void* gy, float* dst,
                   const Geom& g, cudaStream_t stream) {
  const dim3 grid((g.M + kTileM - 1) / kTileM, (g.Co + TN - 1) / TN,
                  g.splits);
  wgrad_lb_kernel<T, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), dst, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tn(int tn, const void* x, const void* gy, float* dst,
                      const Geom& g, cudaStream_t stream) {
  if (tn == 128) return launch<T, 128>(x, gy, dst, g, stream);
  if (tn == 64) return launch<T, 64>(x, gy, dst, g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dW (Hk, Wk, Ci, Co) f32 from x (B, H, W, Ci) and g (B, Ho, Wo, Co),
// both f32 (dtype 0) or bf16 (dtype 1).  With splits > 1 the partial
// tiles go to `ws` (splits x M x Co words) and a second kernel sums
// them into `dw`.
extern "C" int wgrad_lb_forward(
    const void* x, const void* gy, float* dw, float* ws, int B, int H,
    int W, int Ci, int Co, int Hk, int Wk, int Ho, int Wo, int sy, int sx,
    int dy, int dx, int py, int px, int tn, int splits,
    int chunks_per_split, int x_vec, int g_vec, int o_vec, int dtype,
    void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.Hk = Hk; g.Wk = Wk;
  g.Ho = Ho; g.Wo = Wo;
  g.sy = sy; g.sx = sx; g.dy = dy; g.dx = dx; g.py = py; g.px = px;
  g.M = Hk * Wk * Ci;
  g.K = B * Ho * Wo;
  g.splits = splits;
  g.chunks_per_split = chunks_per_split;
  g.x_vec = x_vec && Ci % 4 == 0;
  g.g_vec = g_vec && Co % 4 == 0;
  g.o_vec = o_vec && Co % 4 == 0;
  if (splits < 1 || chunks_per_split < 1 ||
      static_cast<long long>(splits - 1) * chunks_per_split * kChunk >= g.K ||
      static_cast<long long>(splits) * chunks_per_split * kChunk < g.K ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? ws : dw;
  cudaError_t err;
  if (dtype == 0)
    err = launch_tn<float>(tn, x, gy, dst, g, s);
  else if (dtype == 1)
    err = launch_tn<__nv_bfloat16>(tn, x, gy, dst, g, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(g.M) * Co;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096
                                          ? (n + 255) / 256 : 4096);
  wgrad_reduce_kernel<<<blocks, 256, 0, s>>>(ws, dw, n, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgrad_lb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
