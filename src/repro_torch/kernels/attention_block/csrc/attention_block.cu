// Blocked (flash-style) attention forward with causal and
// sliding-window masks and grouped-query heads, f32 or bf16 in, f32
// online-softmax state, the output in the input's type, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` launched by `attention_call`
// (src/repro/kernels/attention_block/kernel.py:22, :63).  It computes
// the same function; it is not a block-by-block copy.
//
// Layout: q (B*H, Sq, hd); k, v (B*KV, Skv, hd); out like q.  Query
// head bh reads kv head bh / groups.
//
// What bounds it on this card.  Per (query, key) pair the work is
// 4*hd operations (the score's dot product and the value update)
// against q, k, v and out read or written once: hundreds of
// operations per byte at the configs' sequence lengths, so operations
// bound it, at the f32 FMA rate without tensor cores.
//
// What the design does about it.
//  * One CTA of 256 threads owns 64 query rows of one head.  Its
//    online-softmax state (acc, m, l) stays in registers for the whole
//    sweep over the keys (the reference's resident output block):
//    each thread holds 4 rows x hd/16 columns of acc and the rows' m
//    and l, and the output is written once.
//  * Per 64-key tile the CTA stages K and V with cp.async,
//    double-buffered, so the next tile arrives while this one is
//    computed; Q is staged once.  S = Q K^T is a 64 x 64 register
//    tile (4 x 4 a thread), the row max and sum are reduced across
//    the 16 lanes that share a row with shuffles, and P goes through
//    shared memory to the P V product.
//  * Rows are padded by 16 bytes in shared memory so that the lanes
//    reading 16 different keys hit different banks.
//  * bf16 stays bf16 in shared memory and is widened to f32 in
//    registers; the output is rounded to nearest-even.
//  * Any head dim up to 256: the kernel is instantiated at widths HD
//    of 8, 16, 32, 64, 80, 96, 128 and 256 and runs a head dim hd at
//    the next width.  The columns from hd to HD of the staged Q, K and
//    V tiles are zeros, so they add nothing to a score and make acc
//    columns that are never stored; the rows in device memory are hd
//    words apart, and a pitch that is not a multiple of 16 bytes is
//    staged a word at a time.  A head dim equal to its width runs an
//    instance where hd is the compile-time HD, which has none of
//    this.  The softmax scale is 1/sqrt(hd).  Where
//    two stages of K and V do not fit in shared memory (f32 at 256),
//    the kernel stages one.
//  * Masks cost little: a query tile visits only the key tiles that
//    hold an unmasked pair (key_tile_range, mirrored in kernel.py: up
//    to the diagonal under causal, from the first tile that reaches
//    q - window + 1 under a window), and masks are applied only on the
//    boundary tiles.  A tile that holds a row with no unmasked key
//    (Sq > Skv + window - 1) visits every key.  The longest query tiles
//    launch first (query tile rank slowest, heads fastest).
//  * Head dims above 256 run as ceil(hd / 256) column chunks, a grid
//    dimension of their own (attention_wide_kernel): each CTA computes
//    the full scores over the whole hd, staging Q and K 256 columns at
//    a time, and accumulates only its own 256 output columns of P V.
//    m and l are the same in every chunk, because the scores are; Q K^T
//    is recomputed once per chunk, at widths no repo config uses.
//  * Plain FMA, no tensor cores or TMA: bf16 at the head dims TMA
//    describes runs on csrc/attention_block_sm90.cu instead.
//
// Masks use absolute positions from 0 on both sides: causal keeps
// k <= q, a window keeps k > q - window (also without causal).  A
// masked score is the finite -1e30 of the reference, so a row with no
// unmasked key gets the mean of V over the Skv real keys, as the
// reference's lax target gives.  A key at k >= Skv does not exist: it
// is predicated away and not counted.
//
// Where the caller passes an lse buffer (f32, (B*H, Sq)), lane 0 of each
// row writes m + ln l over the row's unmasked keys, or -inf where it has
// none (column chunk 0 only above 256); O is computed and stored as
// without it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;     // query rows per CTA
constexpr int kBKV = 64;    // keys per staged tile
constexpr int kWide = 256;  // the widest instance; column chunk above it
constexpr float kNegInf = -1e30f;

struct Geom {
  int BH, Sq, Skv, groups, window, causal;
  int hd;    // the real head dim: the rows' pitch and stored columns
  int vec;   // rows are 16-byte pitched: stage by 16-byte copies
  int nqt;   // query tiles per head
  int chunks;  // 256-column chunks of hd (attention_wide_kernel)
  float scale;
  float* lse;  // (BH, Sq) f32 log-sum-exp, or nullptr
};

// the key tiles [lo, hi) that query rows [q0, q1) visit: every tile
// that holds an unmasked pair, or every tile if a row has no unmasked
// key; mirrors key_tile_range in kernel.py
__device__ __forceinline__ void key_tile_range(int q0, int q1, int Skv,
                                               int window, int causal,
                                               int bkv, int* lo, int* hi) {
  const int nkv = (Skv + bkv - 1) / bkv;
  *lo = 0;
  *hi = nkv;
  if (window > 0 &&
      static_cast<long long>(q1) - 1 >= static_cast<long long>(Skv) +
                                             window - 1)
    return;
  if (causal) *hi = min(nkv, (q1 - 1) / bkv + 1);
  if (window > 0) *lo = max(0, q0 - window + 1) / bkv;
}

// whether key tile [k0, k0 + kBKV) needs masks for rows [q0, q1): a
// key past the diagonal, one too old for the window, or past Skv
__device__ __forceinline__ bool edge_tile(int k0, int q0, int q1,
                                          const Geom& g) {
  return k0 + kBKV > g.Skv || (g.causal && k0 + kBKV - 1 > q0) ||
         (g.window > 0 && static_cast<long long>(k0) <=
                              static_cast<long long>(q1) - 1 - g.window);
}

constexpr int kSmemPerBlock = 232448;

// shared memory of one CTA with `stages` K/V stages: Q, the K and V
// stages, and the P tile
template <typename T, int HD>
constexpr int smem_bytes(int stages) {
  return (kBQ + 2 * stages * kBKV) * (HD + 16 / int(sizeof(T))) *
             int(sizeof(T)) +
         kBQ * (kBKV + 4) * int(sizeof(float));
}

// two stages where they fit, else one
template <typename T, int HD>
constexpr int kStagesFor = smem_bytes<T, HD>(2) <= kSmemPerBlock ? 2 : 1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// n (1, 2 or 4) consecutive staged words, widened
template <int n>
__device__ __forceinline__ void loadn(const float* p, float* out) {
  if (n == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if (n == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

template <int n>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p, float* out) {
  if (n == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else if (n == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x;
    out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the acc columns of one thread: for a multiple of 64, groups of 4 at
// tk*4 + 64*c; otherwise HD/16 consecutive columns at tk*(HD/16),
// loaded 4, 2 or 1 at a time (HD = 8: one column, lanes tk >= 8 idle)
template <int HD>
struct Cols {
  static constexpr bool kSpread = HD % 64 == 0;
  static constexpr int kPer = HD >= 16 ? HD / 16 : 1;   // per thread
  static constexpr int kVec = kSpread || kPer % 4 == 0 ? 4
                              : kPer % 2 == 0         ? 2
                                                      : 1;   // per load
  __device__ static int col(int tk, int c) {
    return kSpread ? (c / 4) * 64 + tk * 4 + (c % 4) : tk * kPer + c;
  }
  __device__ static bool active(int tk) { return tk * kPer < HD; }
};

// stage rows [r0, r0 + 64) and columns [c0, c0 + HD) of a (rows, hd)
// head into a padded tile, zeros outside the head (EXACT: hd == HD and
// c0 == 0, so every column bound is a constant)
template <typename T, int HD, bool EXACT>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int r0,
                                           int rows, int c0, int hd,
                                           bool vec, int tid) {
  constexpr int VE = 16 / sizeof(T);   // words per 16-byte copy
  constexpr int LD = HD + VE;          // padded row of a staged tile
  if (vec) {
    for (int e = tid; e < 64 * (HD / VE); e += kThreads) {
      const int r = e / (HD / VE);
      const int d = (e - r * (HD / VE)) * VE;
      const bool ok = r0 + r < rows && (EXACT || c0 + d < hd);
      cp_async16(dst + r * LD + d,
                 ok ? src + static_cast<size_t>(r0 + r) * hd + c0 + d : src,
                 ok);
    }
  } else {
    for (int e = tid; e < 64 * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      dst[r * LD + d] = r0 + r < rows && c0 + d < hd
                            ? src[static_cast<size_t>(r0 + r) * hd + c0 + d]
                            : zero<T>();
    }
  }
}

// s += Q K^T over the HD staged columns, 4 rows x 4 keys a thread
template <typename T, int HD>
__device__ __forceinline__ void score_tile(float (&s)[4][4], const T* s_q,
                                           const T* s_k, int tq, int tk) {
  constexpr int LD = HD + 16 / sizeof(T);
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float qv[4][4], kv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) loadn<4>(s_q + (tq + 16 * i) * LD + d, qv[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) loadn<4>(s_k + (tk + 16 * j) * LD + d, kv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
  }
}

// masks (on an edge tile only) and the online softmax of one key tile:
// P into the shared tile, acc rescaled; a row's 16 lanes are neighbours
template <int NC>
__device__ __forceinline__ void softmax_tile(float (&s)[4][4],
                                             float (&acc)[4][NC],
                                             float (&m_run)[4],
                                             float (&l_run)[4], float* s_p,
                                             int q0, int k0, bool edge,
                                             int tq, int tk, const Geom& g) {
  constexpr int LP = kBKV + 4;   // padded row of the P tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tq + 16 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (edge) {
        const int kp = k0 + tk + 16 * j;
        const bool masked =
            (g.causal && kp > qp) ||
            (g.window > 0 && static_cast<long long>(kp) <=
                                 static_cast<long long>(qp) - g.window);
        s[i][j] = kp >= g.Skv ? -INFINITY
                  : masked    ? kNegInf
                              : s[i][j] * g.scale;
      } else {
        s[i][j] *= g.scale;
      }
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run[i], mx);
    const float alpha = expf(m_run[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[i][j] - m_new);   // 0 for a key past Skv
      s_p[(tq + 16 * i) * LP + tk + 16 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_run[i] = l_run[i] * alpha + sum;
    m_run[i] = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
  }
}

// acc += P V over one key tile, for the thread's acc columns
template <typename T, int HD>
__device__ __forceinline__ void value_tile(float (&acc)[4][Cols<HD>::kPer],
                                           const float* s_p, const T* s_v,
                                           int tq, int tk) {
  constexpr int LD = HD + 16 / sizeof(T);
  constexpr int LP = kBKV + 4;
  constexpr int NC = Cols<HD>::kPer;
  constexpr int NV = Cols<HD>::kVec;
#pragma unroll 2
  for (int kk = 0; kk < kBKV; kk += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) loadn<4>(s_p + (tq + 16 * i) * LP + kk, pv[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; c += NV)
        loadn<NV>(s_v + (kk + e) * LD + Cols<HD>::col(tk, c), vv + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i][e], vv[c], acc[i][c]);
    }
  }
}

// one store of acc / l: the columns [c0, c0 + HD) of the rows below Sq
template <typename T, int HD, bool EXACT>
__device__ __forceinline__ void store_rows(T* out,
                                           float (&acc)[4][Cols<HD>::kPer],
                                           const float (&l_run)[4], int bh,
                                           int q0, int c0, int tq, int tk,
                                           const Geom& g) {
  const int hd = EXACT ? HD : g.hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tq + 16 * i;
    if (qp >= g.Sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    T* row = out + (static_cast<size_t>(bh) * g.Sq + qp) * hd + c0;
#pragma unroll
    for (int c = 0; c < Cols<HD>::kPer; ++c)
      if (EXACT || c0 + Cols<HD>::col(tk, c) < hd)
        store1(row + Cols<HD>::col(tk, c), acc[i][c] * inv);
  }
}

// each row's log-sum-exp, m + ln l over its unmasked keys (-inf where it
// has none: m is still the initial -1e30), written by the row's lane 0
__device__ __forceinline__ void store_lse(const float (&m_run)[4],
                                          const float (&l_run)[4], int bh,
                                          int q0, int tq, const Geom& g) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tq + 16 * i;
    if (qp < g.Sq)
      g.lse[static_cast<size_t>(bh) * g.Sq + qp] =
          m_run[i] <= kNegInf ? -INFINITY : m_run[i] + logf(l_run[i]);
  }
}

// EXACT: hd == HD, so the pitch and every column bound are constants
template <typename T, int HD, int STAGES, bool EXACT>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 const Geom g) {
  constexpr int LD = HD + 16 / sizeof(T);   // padded row of a staged tile
  constexpr int NC = Cols<HD>::kPer;
  extern __shared__ float4 smem4[];
  T* s_q = reinterpret_cast<T*>(smem4);          // [kBQ][LD]
  T* s_kv = s_q + kBQ * LD;              // STAGES x {K, V} [kBKV][LD]
  float* s_p = reinterpret_cast<float*>(s_kv + 2 * STAGES * kBKV * LD);

  const int hd = EXACT ? HD : g.hd;
  const bool vec = EXACT || g.vec;
  const int tid = threadIdx.x;
  const int tq = tid >> 4;   // rows tq + 16*i
  const int tk = tid & 15;   // keys tk + 16*j; acc columns Cols::col
  // longest query tiles first: tile rank slowest, heads fastest
  const int bh = blockIdx.x % g.BH;
  const int q0 = (g.nqt - 1 - static_cast<int>(blockIdx.x / g.BH)) * kBQ;
  const int q1 = min(q0 + kBQ, g.Sq);
  const T* qh = q + static_cast<size_t>(bh) * g.Sq * hd;
  const size_t kv_off = static_cast<size_t>(bh / g.groups) * g.Skv * hd;
  const T* kh = k + kv_off;
  const T* vh = v + kv_off;
  auto stage = [&](T* dst, const T* src, int r0, int rows) {
    stage_tile<T, HD, EXACT>(dst, src, r0, rows, 0, hd, vec, tid);
  };

  float acc[4][NC];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  key_tile_range(q0, q1, g.Skv, g.window, g.causal, kBKV, &lo, &hi);
  stage(s_q, qh, q0, g.Sq);
  stage(s_kv, kh, lo * kBKV, g.Skv);
  stage(s_kv + kBKV * LD, vh, lo * kBKV, g.Skv);
  cp_async_commit();
  for (int t = lo; t < hi; ++t) {
    const int cur = STAGES == 2 ? (t - lo) & 1 : 0;
    if (STAGES == 2 && t + 1 < hi) {
      // the other buffer was last read before the previous barrier
      T* nxt = s_kv + (cur ^ 1) * 2 * kBKV * LD;
      stage(nxt, kh, (t + 1) * kBKV, g.Skv);
      stage(nxt + kBKV * LD, vh, (t + 1) * kBKV, g.Skv);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      if (STAGES == 1 && t > lo) {
        // one stage: this tile replaces the last, read before the
        // previous barrier
        stage(s_kv, kh, t * kBKV, g.Skv);
        stage(s_kv + kBKV * LD, vh, t * kBKV, g.Skv);
        cp_async_commit();
      }
      cp_async_wait_all();
    }
    __syncthreads();
    const T* s_k = s_kv + cur * 2 * kBKV * LD;
    const T* s_v = s_k + kBKV * LD;
    const int k0 = t * kBKV;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    score_tile<T, HD>(s, s_q, s_k, tq, tk);
    softmax_tile<NC>(s, acc, m_run, l_run, s_p, q0, k0,
                     edge_tile(k0, q0, q1, g), tq, tk, g);
    __syncthreads();
    if (Cols<HD>::active(tk)) value_tile<T, HD>(acc, s_p, s_v, tq, tk);
    __syncthreads();
  }

  if (g.lse != nullptr && tk == 0) store_lse(m_run, l_run, bh, q0, tq, g);
  if (!Cols<HD>::active(tk)) return;
  store_rows<T, HD, EXACT>(out, acc, l_run, bh, q0, 0, tq, tk, g);
}

// a head dim above kWide: blockIdx.y picks this CTA's kWide output
// columns; the scores run over every kWide-column chunk of Q and K,
// staged one chunk at a time (one stage)
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      const Geom g) {
  constexpr int HD = kWide;
  constexpr int LD = HD + 16 / sizeof(T);
  constexpr int NC = Cols<HD>::kPer;
  extern __shared__ float4 smem4[];
  T* s_q = reinterpret_cast<T*>(smem4);   // [kBQ][LD], one chunk
  T* s_k = s_q + kBQ * LD;                // [kBKV][LD], one chunk
  T* s_v = s_k + kBKV * LD;               // [kBKV][LD], own columns
  float* s_p = reinterpret_cast<float*>(s_v + kBKV * LD);

  const int tid = threadIdx.x;
  const int tq = tid >> 4;
  const int tk = tid & 15;
  const int bh = blockIdx.x % g.BH;
  const int q0 = (g.nqt - 1 - static_cast<int>(blockIdx.x / g.BH)) * kBQ;
  const int q1 = min(q0 + kBQ, g.Sq);
  const int c0 = blockIdx.y * HD;   // this CTA's output columns
  const T* qh = q + static_cast<size_t>(bh) * g.Sq * g.hd;
  const size_t kv_off = static_cast<size_t>(bh / g.groups) * g.Skv * g.hd;
  const T* kh = k + kv_off;
  const T* vh = v + kv_off;
  const bool vec = g.vec;

  float acc[4][NC];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  key_tile_range(q0, q1, g.Skv, g.window, g.causal, kBKV, &lo, &hi);
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kBKV;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < g.chunks; ++c) {
      // both tiles were last read before the previous barrier
      stage_tile<T, HD, false>(s_q, qh, q0, g.Sq, c * HD, g.hd, vec, tid);
      stage_tile<T, HD, false>(s_k, kh, k0, g.Skv, c * HD, g.hd, vec, tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      score_tile<T, HD>(s, s_q, s_k, tq, tk);
      __syncthreads();
    }
    // this CTA's V columns arrive while the softmax runs
    stage_tile<T, HD, false>(s_v, vh, k0, g.Skv, c0, g.hd, vec, tid);
    cp_async_commit();
    softmax_tile<NC>(s, acc, m_run, l_run, s_p, q0, k0,
                     edge_tile(k0, q0, q1, g), tq, tk, g);
    cp_async_wait_all();
    __syncthreads();
    value_tile<T, HD>(acc, s_p, s_v, tq, tk);
    __syncthreads();
  }
  // the scores, so m and l, are the same in every column chunk
  if (g.lse != nullptr && tk == 0 && blockIdx.y == 0)
    store_lse(m_run, l_run, bh, q0, tq, g);
  store_rows<T, HD, false>(out, acc, l_run, bh, q0, c0, tq, tk, g);
}

template <typename T, int HD, bool EXACT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Geom& g, cudaStream_t stream) {
  constexpr int stages = kStagesFor<T, HD>;
  constexpr int smem = smem_bytes<T, HD>(stages);
  static_assert(smem <= kSmemPerBlock, "attention tile exceeds shared memory");
  static bool opted_in = false;
  if (!opted_in && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T, HD, stages, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(static_cast<unsigned>(g.nqt) * g.BH);
  attention_kernel<T, HD, stages, EXACT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, const Geom& g, cudaStream_t stream) {
  // Q and K chunks and own V columns: the one-stage tile of width kWide
  constexpr int smem = smem_bytes<T, kWide>(1);
  static_assert(smem <= kSmemPerBlock, "attention tile exceeds shared memory");
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_wide_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(static_cast<unsigned>(g.nqt) * g.BH, g.chunks);
  attention_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         void* out, const Geom& g, cudaStream_t s) {
  return g.hd == HD ? launch<T, HD, true>(q, k, v, out, g, s)
                    : launch<T, HD, false>(q, k, v, out, g, s);
}

// HD: the instantiated width, from the wrapper (>= the real hd, or
// kWide for a head dim above it)
template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* k, const void* v,
                      void* out, const Geom& g, cudaStream_t s) {
  if (g.hd > kWide) return launch_wide<T>(q, k, v, out, g, s);
  switch (HD) {
    case 8: return launch_width<T, 8>(q, k, v, out, g, s);
    case 16: return launch_width<T, 16>(q, k, v, out, g, s);
    case 32: return launch_width<T, 32>(q, k, v, out, g, s);
    case 64: return launch_width<T, 64>(q, k, v, out, g, s);
    case 80: return launch_width<T, 80>(q, k, v, out, g, s);
    case 96: return launch_width<T, 96>(q, k, v, out, g, s);
    case 128: return launch_width<T, 128>(q, k, v, out, g, s);
    case 256: return launch_width<T, 256>(q, k, v, out, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  hd is the real head dim, hd_pad the
// instantiated width the kernel runs it at (256 for a head dim above
// 256, which runs as ceil(hd / 256) column chunks).  Every operand's base must
// be 16-byte aligned (the wrapper checks it).  lse is nullptr or an f32
// (BH, Sq) buffer for each row's log-sum-exp.
extern "C" int attention_block_forward_lse(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int BH, int Sq,
                                           int Skv, int hd, int hd_pad,
                                           int groups, int window,
                                           int causal, int dtype,
                                           void* stream) {
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int chunks = (hd + kWide - 1) / kWide;
  if (BH < 1 || Sq < 1 || Skv < 1 || groups < 1 || hd < 1 || window < 0 ||
      (hd > hd_pad && hd_pad != kWide) ||
      static_cast<long long>(nqt) * BH > 0x7fffffffLL || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.BH = BH;
  g.Sq = Sq;
  g.Skv = Skv;
  g.groups = groups;
  g.window = window;
  g.causal = causal;
  g.hd = hd;
  g.vec = hd % (dtype == 0 ? 4 : 8) == 0;
  g.nqt = nqt;
  g.chunks = chunks;
  // the reference's 1 / hd ** 0.5 of the real hd, rounded once to f32
  g.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  g.lse = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd_pad, q, k, v, out, g, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd_pad, q, k, v, out, g, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// the same without the log-sum-exp
extern "C" int attention_block_forward(const void* q, const void* k,
                                       const void* v, void* out, int BH,
                                       int Sq, int Skv, int hd, int hd_pad,
                                       int groups, int window, int causal,
                                       int dtype, void* stream) {
  return attention_block_forward_lse(q, k, v, out, nullptr, BH, Sq, Skv, hd,
                                     hd_pad, groups, window, causal, dtype,
                                     stream);
}

extern "C" const char* attention_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
