// Batch-folded, psum-stationary NHWC convolution with a fused
// bias -> residual -> ReLU -> max-pool epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_conv_kernel` launched by `conv_lb_call`
// (src/repro/kernels/conv_lb/kernel.py:116).  It computes the same
// function; it is not a block-by-block copy of it.
//
// What bounds it on this card.  For VGG's 3x3 layers the work is f32
// operations: 2*9*Ci FLOP per output word against a few bytes moved
// per word, far above the card's f32 balance (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP per byte).  conv1_1 (Ci = 3) and the 1x1
// projections of ResNet do so little arithmetic per word that the
// bytes they move bound them.
//
// What the design does about it.
//  * Operations: one CTA of 256 threads owns a 128-pixel x TN-channel
//    output tile (u x z of the paper: up to 128 output pixels of bb
//    images x TN output channels).  Its f32 sums stay in registers, 8
//    pixels x TN/16 channels per thread, across the whole loop over Ci
//    blocks, so every staged word feeds many FMAs and nothing is
//    written before the epilogue (the paper's OutR).
//  * Bytes: per Ci block the CTA stages the halo-extended input tile
//    and the (Hk, Wk, ci_b, TN) weight slice in shared memory once and
//    serves all Hk x Wk windows from that one tile (WndR): each input
//    word is read from device memory once per CTA, not once per
//    window.  Staging is asynchronous (cp.async, 16 bytes a copy where
//    the channels allow) into two buffers, so the next Ci block
//    arrives while this one is computed.  Padding, ragged edges and
//    lhs-dilation zeros come from predicates (a predicated-off copy
//    writes zeros), never from memory, so no padded copy of x is made.
//    A large window whose whole weight slice does not fit (beyond 7x7
//    at 64 channels) is staged one kernel row at a time: each step
//    then holds the halo rows and the (Wk, ci_b, TN) slice of one
//    kernel row, and the steps run over (Ci block, kernel row).
//    The epilogue adds bias and the residual (read once per output
//    tile), applies the ReLU and the aligned pool x pool max, and
//    stores only the pooled tile: one write per pooled output word.
//  * Plain FMA, no tensor cores or TMA yet.
//
// Types.  The kernel is instantiated for f32 and bf16 operands (one
// type across x, w, bias, residual and out), the reference Pallas
// kernel's semantics: bf16 stays bf16 in device and shared memory and
// is widened to f32 at the FMA; the sums and the whole epilogue run in
// f32, and the result is rounded once, to nearest even, on store.  A
// bf16 pixel of Ci = 3 channels (VGG's conv1_1) is 6 bytes, which
// cp.async (4, 8 or 16 aligned bytes) cannot copy: channels that do not
// come in 16-byte groups are staged by plain loads instead.
//
// Lhs dilation (the dgrad geometry).  The kernel walks the logical
// plane: logical row r of the unpadded, dilated plane is real only
// where r % ly == 0, and then reads compact row r / ly; every other
// row is a zero from the predicate.  Columns likewise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;   // output pixels per CTA (bb*ty*tx <= 128)
constexpr int kCiB = 8;       // input channels staged per step

struct Geom {
  int B, H, W, Ci, Co, Hk, Wk, Ho, Wo;
  int sy, sx, dy, dx, ly, lx, py, px;
  int pool, relu;
  int bb, ty, tx;   // CTA output tile: bb images x ty rows x tx cols
  int hy, hx;       // logical halo extent of one staged step
  int nty, ntx;     // tiles along Ho and Wo
  int x_vec;        // x 16-byte aligned, Ci a multiple of 16 bytes' words
  int w_vec;        // w 16-byte aligned, Co a multiple of 16 bytes' words
  int o_vec;        // out (and residual) 16-byte aligned, Co % 4 == 0
};

// global -> shared copies that bypass registers; a copy whose predicate
// is off reads nothing and writes zeros
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

__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 consecutive bf16 words (8 bytes), widened
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// 4 consecutive words, each rounded once to the output type
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<const uint32_t*>(&lo);
  a.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

// one staged bf16 word: a 16-byte copy where the words come in 16-byte
// groups (vec); otherwise a plain load (2 bytes, which cp.async cannot
// copy), a zero where !ok
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool ok, bool vec) {
  if (vec)
    cp_async16(dst, src, ok);
  else
    *dst = ok ? *src : __float2bfloat16_rn(0.f);
}

// T: the operand type (float or __nv_bfloat16); the f32 instance is
// the f32-only kernel's code, statement for statement, so it compiles
// to the same PTX.  ROWS: stage one kernel row per step (a window
// whose whole weight slice does not fit); otherwise the whole window
// per Ci block
template <typename T, int TN, bool ROWS>
__global__ void __launch_bounds__(kThreads, 2)
conv_lb_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, const T* __restrict__ res,
               T* __restrict__ out, const Geom g) {
  constexpr int NJ = TN / 16;  // output channels per thread
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int halo_px = g.bb * g.hy * g.hx;
  const int krows = ROWS ? 1 : g.Hk;   // kernel rows staged per step
  const int nwin = krows * g.Wk;       // windows staged per step
  // one stage buffer: [halo_px][kCiB] input, then [nwin][kCiB][TN] weights
  const int in_words = halo_px * kCiB;
  const int stage_words = in_words + nwin * kCiB * TN;

  const int tid = threadIdx.x;
  const int tm = tid >> 4;   // pixel lane: pixels tm + 16*i
  const int tn = tid & 15;   // channel lane: tn*4 + j (and 64 + tn*4 + j)

  int t = blockIdx.x;
  const int xt = t % g.ntx;
  t /= g.ntx;
  const int yt = t % g.nty;
  const int bt = t / g.nty;
  const int b0 = bt * g.bb, oy0 = yt * g.ty, ox0 = xt * g.tx;
  const int co0 = blockIdx.y * TN;
  const int tile_hw = g.ty * g.tx;
  const int tile_px = g.bb * tile_hw;

  // each thread's 8 pixels as offsets into the staged halo tile
  int pix[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int m = tm + 16 * i;
    if (m >= tile_px) m = 0;   // idle slot: reads a staged word, never stored
    const int lb = m / tile_hw;
    const int r = m - lb * tile_hw;
    const int ry = r / g.tx;
    const int rx = r - ry * g.tx;
    pix[i] = ((lb * g.hy + ry * g.sy) * g.hx + rx * g.sx) * kCiB;
  }

  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // logical origin of the tile's halo in the unpadded dilated plane
  const int r0 = oy0 * g.sy - g.py;
  const int c0 = ox0 * g.sx - g.px;
  const int hd = (g.H - 1) * g.ly + 1;
  const int wd = (g.W - 1) * g.lx + 1;
  const int hyx = g.hy * g.hx;

  // issue the copies of one step (Ci block, first kernel row ky0) into
  // one stage buffer
  auto stage = [&](int step, T* s_in, T* s_w) {
    const int ci0 = (ROWS ? step / g.Hk : step) * kCiB;
    const int ky0 = ROWS ? step % g.Hk : 0;
    const int per_px = g.x_vec ? kCiB / (kF32 ? 4 : 8) : kCiB;
    for (int e = tid; e < halo_px * per_px; e += kThreads) {
      const int p = e / per_px;
      const int c = (e - p * per_px) * (kCiB / per_px);
      const int lb = p / hyx;
      const int q = p - lb * hyx;
      const int qy = q / g.hx;
      const int r = r0 + ky0 * g.dy + qy;
      const int col = c0 + (q - qy * g.hx);
      const int b = b0 + lb;
      const int ci = ci0 + c;
      const bool ok = b < g.B && ci < g.Ci && r >= 0 && r < hd &&
                      col >= 0 && col < wd && r % g.ly == 0 &&
                      col % g.lx == 0;
      const T* src =
          ok ? x + ((static_cast<size_t>(b) * g.H + r / g.ly) * g.W +
                    col / g.lx) * g.Ci + ci
             : x;
      if constexpr (kF32) {
        if (g.x_vec)
          cp_async16(s_in + p * kCiB + c, src, ok);
        else
          cp_async4(s_in + p * kCiB + c, src, ok);
      } else {
        stage_bf16(s_in + p * kCiB + c, src, ok, g.x_vec);
      }
    }
    const int per_row = g.w_vec ? TN / (kF32 ? 4 : 8) : TN;
    for (int e = tid; e < nwin * kCiB * per_row; e += kThreads) {
      const int q = e / per_row;          // (win, c) row of the slice
      const int n = (e - q * per_row) * (TN / per_row);
      const int c = q % kCiB;
      const int win = q / kCiB;
      const int ci = ci0 + c;
      const int co = co0 + n;
      const bool ok = ci < g.Ci && co < g.Co;
      const T* src =
          ok ? w + (static_cast<size_t>(ky0 * g.Wk + win) * g.Ci + ci) *
                       g.Co + co
             : w;
      if constexpr (kF32) {
        if (g.w_vec)
          cp_async16(s_w + q * TN + n, src, ok);
        else
          cp_async4(s_w + q * TN + n, src, ok);
      } else {
        stage_bf16(s_w + q * TN + n, src, ok, g.w_vec);
      }
    }
  };

  const int nkb = (g.Ci + kCiB - 1) / kCiB * (ROWS ? g.Hk : 1);
  stage(0, smem, smem + in_words);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    const T* s_in = smem + (kb & 1) * stage_words;
    const T* s_w = s_in + in_words;
    if (kb + 1 < nkb) {
      // the other buffer was last read before the previous barrier
      T* nxt = smem + ((kb + 1) & 1) * stage_words;
      stage(kb + 1, nxt, nxt + in_words);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    // every staged window served from the one staged tile
    for (int ky = 0; ky < krows; ++ky) {
      for (int kx = 0; kx < g.Wk; ++kx) {
        const T* a_base = s_in + (ky * g.dy * g.hx + kx * g.dx) * kCiB;
        const T* b_base = s_w + (ky * g.Wk + kx) * kCiB * TN + tn * 4;
#pragma unroll
        for (int c = 0; c < kCiB; ++c) {
          float a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = widen(a_base[pix[i] + c]);
          float bv[NJ];
          if constexpr (kF32) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(b_base + c * TN);
            bv[0] = b4.x;
            bv[1] = b4.y;
            bv[2] = b4.z;
            bv[3] = b4.w;
            if (NJ == 8) {
              const float4 b5 =
                  *reinterpret_cast<const float4*>(b_base + c * TN + 64);
              bv[NJ - 4] = b5.x;
              bv[NJ - 3] = b5.y;
              bv[NJ - 2] = b5.z;
              bv[NJ - 1] = b5.w;
            }
          } else {
            load4(b_base + c * TN, bv);
            if (NJ == 8) load4(b_base + c * TN + 64, bv + NJ - 4);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue on the register tile: + bias -> + residual -> ReLU, in
  // groups of 4 contiguous channels (j = 4*q .. 4*q + 3)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = tm + 16 * i;
    const int lb = m / tile_hw;
    const int r = m - lb * tile_hw;
    const int ry = r / g.tx;
    const int b = b0 + lb;
    const int oy = oy0 + ry;
    const int ox = ox0 + (r - ry * g.tx);
    const bool valid = m < tile_px && b < g.B && oy < g.Ho && ox < g.Wo;
    const size_t base =
        ((static_cast<size_t>(b) * g.Ho + oy) * g.Wo + ox) * g.Co;
#pragma unroll
    for (int q = 0; q < NJ / 4; ++q) {
      const int co = co0 + q * 64 + tn * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][4 * q + j];
        if (bias != nullptr && co + j < g.Co) v[j] += widen(bias[co + j]);
      }
      if (res != nullptr && valid) {
        if (g.o_vec) {
          if (co < g.Co) {
            float r4[4];
            if constexpr (kF32) {
              const float4 f4 =
                  *reinterpret_cast<const float4*>(res + base + co);
              r4[0] = f4.x;
              r4[1] = f4.y;
              r4[2] = f4.z;
              r4[3] = f4.w;
            } else {
              load4(res + base + co, r4);
            }
            v[0] += r4[0];
            v[1] += r4[1];
            v[2] += r4[2];
            v[3] += r4[3];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (co + j < g.Co) v[j] += widen(res[base + co + j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (g.relu) v[j] = fmaxf(v[j], 0.f);
        acc[i][4 * q + j] = v[j];
      }
      if (g.pool == 1 && valid) {
        if (g.o_vec) {
          if (co < g.Co) store4(out + base + co, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (co + j < g.Co) out[base + co + j] = narrow<T>(v[j]);
        }
      }
    }
  }
  if (g.pool == 1) return;

  // aligned pool x pool max: tiles start on pool-aligned rows/cols, so
  // every window lies inside this CTA's tile; the stage buffers are
  // free after the last barrier of the Ci loop; the pre-pool tile is f32
  float* s_out = reinterpret_cast<float*>(smem4);   // [kTileM][TN]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      s_out[(tm + 16 * i) * TN + (j / 4) * 64 + tn * 4 + (j & 3)] = acc[i][j];
  __syncthreads();
  const int p = g.pool;
  const int pty = g.ty / p, ptx = g.tx / p;
  const int hp = g.Ho / p, wp = g.Wo / p;
  const int npool = g.bb * pty * ptx;
  for (int e = tid; e < npool * TN; e += kThreads) {
    const int n = e % TN;
    const int q = e / TN;
    const int lb = q / (pty * ptx);
    const int s = q - lb * pty * ptx;
    const int qy = s / ptx;
    const int qx = s - qy * ptx;
    const int b = b0 + lb;
    const int oyp = oy0 / p + qy;
    const int oxp = ox0 / p + qx;
    const int co = co0 + n;
    if (b < g.B && oyp < hp && oxp < wp && co < g.Co) {
      float mx = -INFINITY;
      for (int u = 0; u < p; ++u)
        for (int v = 0; v < p; ++v) {
          const int m = (lb * g.ty + qy * p + u) * g.tx + qx * p + v;
          mx = fmaxf(mx, s_out[m * TN + n]);
        }
      out[((static_cast<size_t>(b) * hp + oyp) * wp + oxp) * g.Co + co] =
          narrow<T>(mx);
    }
  }
}

template <typename T, int TN, bool ROWS>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* res, void* out, const Geom& g,
                   int smem_bytes, cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if (smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_lb_kernel<T, TN, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = smem_bytes;
  }
  const int nbt = (g.B + g.bb - 1) / g.bb;
  const dim3 grid(nbt * g.nty * g.ntx, (g.Co + TN - 1) / TN);
  conv_lb_kernel<T, TN, ROWS><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(res),
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T, int TN>
cudaError_t launch_rows(const void* x, const void* w, const void* bias,
                        const void* res, void* out, const Geom& g,
                        bool rows, int smem_bytes, cudaStream_t stream) {
  return rows ? launch<T, TN, true>(x, w, bias, res, out, g, smem_bytes,
                                    stream)
              : launch<T, TN, false>(x, w, bias, res, out, g, smem_bytes,
                                     stream);
}

template <typename T>
cudaError_t launch_tn(int tn, const void* x, const void* w,
                      const void* bias, const void* res, void* out,
                      const Geom& g, bool rows, int smem_bytes,
                      cudaStream_t stream) {
  if (tn == 128)
    return launch_rows<T, 128>(x, w, bias, res, out, g, rows, smem_bytes,
                               stream);
  if (tn == 64)
    return launch_rows<T, 64>(x, w, bias, res, out, g, rows, smem_bytes,
                              stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, for every operand and the output
extern "C" int conv_lb_forward(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, int B, int H, int W, int Ci, int Co, int Hk, int Wk,
    int Ho, int Wo, int sy, int sx, int dy, int dx, int ly, int lx,
    int py, int px, int pool, int relu, int bb, int ty, int tx, int tn,
    int krows, int x_vec, int w_vec, int o_vec, int dtype, int smem_bytes,
    void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.Hk = Hk; g.Wk = Wk;
  g.Ho = Ho; g.Wo = Wo;
  g.sy = sy; g.sx = sx; g.dy = dy; g.dx = dx; g.ly = ly; g.lx = lx;
  g.py = py; g.px = px;
  g.pool = pool; g.relu = relu;
  g.bb = bb; g.ty = ty; g.tx = tx;
  g.hy = (ty - 1) * sy + (krows - 1) * dy + 1;
  g.hx = (tx - 1) * sx + (Wk - 1) * dx + 1;
  g.nty = (Ho + ty - 1) / ty;
  g.ntx = (Wo + tx - 1) / tx;
  // words per 16-byte copy: 4 f32, 8 bf16
  const int vw = dtype == 0 ? 4 : 8;
  g.x_vec = x_vec && Ci % vw == 0;
  g.w_vec = w_vec && Co % vw == 0;
  g.o_vec = o_vec && Co % 4 == 0;
  if (bb * ty * tx > kTileM || ty % pool || tx % pool ||
      (krows != Hk && krows != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows = krows != Hk;
  cudaError_t err;
  if (dtype == 0)
    err = launch_tn<float>(tn, x, w, bias, res, out, g, rows, smem_bytes, s);
  else if (dtype == 1)
    err = launch_tn<__nv_bfloat16>(tn, x, w, bias, res, out, g, rows,
                                   smem_bytes, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* conv_lb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
