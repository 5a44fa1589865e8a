// Psum-stationary matmul (M, K) @ (K, N) -> (M, N), f32 or bf16 in,
// f32 sums, the output in the input's type, for Hopper (sm_90a).
//
// Replaces, with csrc/matmul_lb_sm90.cu, the TPU kernel
// `_matmul_kernel` launched by `matmul_lb_call`
// (src/repro/kernels/matmul_lb/kernel.py:23, :36).  It computes the
// same function; it is not a block-by-block copy.  It runs f32, and the
// bf16 products whose operands TMA cannot describe (kernel.py `route`);
// every other bf16 product runs on the tensor cores in the sm90 kernel.
//
// What bounds it on this card.  At the shapes the repo's configs give
// (thousands of rows, columns and reduction steps) the work is
// 2*M*N*K operations against (M*K + K*N + M*N) words: hundreds of
// operations per byte, far above the card's balance, so operations
// bound it.  Without tensor cores that is the f32 FMA rate for both
// types; a bf16 bound at the tensor-core rate is 15x lower.
//
// What the design does about it.
//  * One CTA of 256 threads owns a 128 x TN (64 or 128) output tile.
//    Its f32 sums stay in registers, 8 rows x TN/16 columns a thread,
//    across the whole K sweep (the reference's resident f32
//    accumulator block), and each output word is written once.
//  * Per 16-deep K step the CTA stages the 128 x 16 A slice and the
//    16 x TN B slice in shared memory with cp.async, double-buffered,
//    so the next slice arrives while this one is computed.  Each
//    staged word feeds 8 (B) or TN/16 (A) FMAs of one thread.
//  * bf16 stays bf16 in shared memory and is widened to f32 in
//    registers; the output is rounded to nearest-even.
//  * Ragged and misaligned operands are predicated, never padded: a
//    row pitch that is not a multiple of 16 bytes (K or N not a
//    multiple of 4 f32 / 8 bf16 words) or a base that is not 16-byte
//    aligned takes 4-byte copies (f32) or element loads (bf16); a
//    predicated-off copy writes zeros.
//  * Plain FMA, no tensor cores or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;   // output rows per CTA
constexpr int kBK = 16;       // reduction depth staged per step

struct Geom {
  int M, N, K;
  int a_vec;   // A rows 16-byte pitched and based
  int b_vec;   // B rows likewise
  int c_vec;   // C rows: 4-word groups may be stored whole
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
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

// one element of a ragged or misaligned operand: a 4-byte copy for
// f32, a load through a register for bf16 (cp.async has no 2-byte
// form); off the edge it writes a zero
__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         bool ok) {
  cp_async4(dst, src, ok);
}

__device__ __forceinline__ void copy_one(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16_rn(0.f);
}

// four consecutive staged words, widened
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 2)
matmul_lb_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ c, const Geom g) {
  constexpr int NJ = TN / 16;              // output columns per thread
  constexpr int VE = 16 / sizeof(T);       // words per 16-byte copy
  __shared__ __align__(16) T s_a[2][kTileM * kBK];   // [row][k]
  __shared__ __align__(16) T s_b[2][kBK * TN];       // [k][col]

  const int tid = threadIdx.x;
  const int tm = tid >> 4;   // rows tm + 16*i
  const int tn = tid & 15;   // columns tn*4 + j (and 64 + tn*4 + j)
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * kTileM;

  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // issue the copies of one K step into one stage buffer
  auto stage = [&](int k0, T* sa, T* sb) {
    if (g.a_vec) {
      for (int e = tid; e < kTileM * kBK / VE; e += kThreads) {
        const int r = e / (kBK / VE);
        const int kk = (e - r * (kBK / VE)) * VE;
        const bool ok = m0 + r < g.M && k0 + kk < g.K;
        const T* src = ok ? a + static_cast<size_t>(m0 + r) * g.K + k0 + kk
                          : a;
        cp_async16(sa + r * kBK + kk, src, ok);
      }
    } else {
      for (int e = tid; e < kTileM * kBK; e += kThreads) {
        const int r = e / kBK;
        const int kk = e - r * kBK;
        const bool ok = m0 + r < g.M && k0 + kk < g.K;
        const T* src = ok ? a + static_cast<size_t>(m0 + r) * g.K + k0 + kk
                          : a;
        copy_one(sa + e, src, ok);
      }
    }
    if (g.b_vec) {
      for (int e = tid; e < kBK * TN / VE; e += kThreads) {
        const int kk = e / (TN / VE);
        const int n = (e - kk * (TN / VE)) * VE;
        const bool ok = k0 + kk < g.K && n0 + n < g.N;
        const T* src = ok ? b + static_cast<size_t>(k0 + kk) * g.N + n0 + n
                          : b;
        cp_async16(sb + kk * TN + n, src, ok);
      }
    } else {
      for (int e = tid; e < kBK * TN; e += kThreads) {
        const int kk = e / TN;
        const int n = e - kk * TN;
        const bool ok = k0 + kk < g.K && n0 + n < g.N;
        const T* src = ok ? b + static_cast<size_t>(k0 + kk) * g.N + n0 + n
                          : b;
        copy_one(sb + e, src, ok);
      }
    }
  };

  const int nkb = (g.K + kBK - 1) / kBK;
  stage(0, s_a[0], s_b[0]);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < nkb) {
      // the other buffer was last read before the previous barrier
      stage((kb + 1) * kBK, s_a[cur ^ 1], s_b[cur ^ 1]);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    const T* sa = s_a[cur];
    const T* sb = s_b[cur] + tn * 4;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = widen(sa[(tm + 16 * i) * kBK + kk]);
      float bv[NJ];
      load4(sb + kk * TN, bv);
      if (NJ == 8) load4(sb + kk * TN + 64, bv + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // one store per output word, in groups of 4 columns
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm + 16 * i;
    if (m >= g.M) continue;
    T* row = c + static_cast<size_t>(m) * g.N;
#pragma unroll
    for (int q = 0; q < NJ / 4; ++q) {
      const int n = n0 + q * 64 + tn * 4;
      if (g.c_vec) {
        if (n < g.N) store4(row + n, &acc[i][4 * q]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.N) store1(row + n + j, acc[i][4 * q + j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, const Geom& g,
                   int tn, cudaStream_t stream) {
  const dim3 grid((g.N + tn - 1) / tn, (g.M + kTileM - 1) / kTileM);
  if (tn == 128)
    matmul_lb_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), g);
  else if (tn == 64)
    matmul_lb_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), g);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  a_vec / b_vec / c_vec: the operand's base
// is 16-byte aligned (the kernel adds the pitch condition itself).
extern "C" int matmul_lb_forward(const void* a, const void* b, void* c,
                                 int M, int N, int K, int tn, int dtype,
                                 int a_vec, int b_vec, int c_vec,
                                 void* stream) {
  const int ve = dtype == 0 ? 4 : 8;
  Geom g;
  g.M = M;
  g.N = N;
  g.K = K;
  g.a_vec = a_vec && K % ve == 0;
  g.b_vec = b_vec && N % ve == 0;
  g.c_vec = c_vec && N % 4 == 0;
  if (M < 1 || N < 1 || K < 1 || (M + kTileM - 1) / kTileM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(a, b, c, g, tn, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a, b, c, g, tn, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* matmul_lb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
