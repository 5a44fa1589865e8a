// Psum-stationary matmul (M, K) @ (K, N) -> (M, N) in f32 on Hopper's
// tensor cores (sm_90a), in 3xTF32: f32 in, f32 sums, f32 out.
//
// Replaces, with csrc/matmul_lb_sm90.cu (bf16) and csrc/matmul_lb.cu
// (which keeps the layouts TMA cannot describe), the TPU kernel
// `_matmul_kernel` launched by `matmul_lb_call`
// (src/repro/kernels/matmul_lb/kernel.py:23, :36).  That kernel keeps a
// (bm, bn) f32 accumulator resident over the K sweep and writes each
// output word once; this one computes the same function, designed for
// this card.
//
// What bounds it on this card.  At the repo's shapes (phi3-medium-14b's
// projections at 4096 tokens) the work is 2*M*N*K operations against
// (M*K + K*N + M*N) 4-byte words: hundreds of operations per byte, so
// the operations bound it.  On FMA (67 TFLOP/s) no kernel gets under
// 26.4 ms for the four projections.  TF32 on the tensor cores runs at
// 495 TFLOP/s but keeps 10 mantissa bits; 3xTF32 splits each word v into
// hi and lo and sums lo*hi + hi*lo + hi*hi (lo*lo, about 2^-20 of a
// product, is dropped): close to f32 accuracy at a third of the TF32
// rate, a bound of 10.7 ms for the same work.
//
// What the design does about it (csrc/matmul_lb_sm90.cu's ring, with
// csrc/wgrad_lb_sm90_tf32.cu's 3xTF32 machinery).
//  * The ring.  One producer thread keeps a TMA ring of kStages stages
//    full, each an A tile (128 rows x 32 f32 of x, one 128-byte swizzled
//    row a row: K-major already) and a w tile (32 of K x BN, as w lies),
//    with a "full" and an "empty" mbarrier per stage; the CTAs run in
//    groups of kGroupM row tiles, row tile fastest, so that a wave's
//    tiles stay in L2.  The producer warpgroup gives its registers away
//    (setmaxnreg).
//  * A in registers.  TF32 wgmma reads shared memory K-major only, but
//    A may come from registers in any order.  Per stage each consumer
//    thread takes its two rows' 8 words [8c, 8c + 8) (c = lane % 4),
//    a 16-byte load a row each half stage (conflict-free: a quarter
//    warp's 8 lanes are 2 rows x 4 chunks, the swizzle puts them in 8
//    distinct 16-byte chunks), and k8 step kk takes word 2kk as fragment
//    column c and word 2kk + 1 as column c + 4: the K order inside a
//    32-deep stage is permuted, and the B tiles are written in the same
//    order.
//  * The split is hi = v's top 19 bits (masked: a TF32 value exactly,
//    read unchanged however the tensor cores read an operand's low 13
//    bits) and lo = v - hi (exact in f32, read as TF32 in turn), two
//    instructions a word, in registers for A.
//  * B rewritten by producer warps.  Three warps of the producer
//    warpgroup rewrite each w tile once into K-major hi and lo tiles
//    (each output column a 128-byte row of the 32 K words in the
//    permuted order, 128-byte swizzle) in a ring of kBStages stages,
//    fence them to the async proxy and signal the consumers.  An
//    N-major w (a contiguous (K, N)) is transposed in that pass (a lane
//    a column: 4-byte loads along a K row of its box); a K-major w (w.t()
//    of a contiguous (N, K)) is only split and permuted (16-byte loads
//    of its rows).
//  * The products.  Two consumer warpgroups each own 64 rows x BN (64 or
//    128) columns and run three wgmma m64nBNk8 .tf32 per k8 step into one
//    accumulator: lo*hi, hi*lo, hi*hi.  A fragments alternate between two
//    buffers with one group left in flight while the next step's are
//    split.
//  * Promotion.  The tensor cores' f32 sums drift in proportion to the
//    length of the range they sum (the 3xTF32 wgrad kernel measured 1.8e-4
//    of max |dW| at a depth of 25,088; phi3-medium-14b's FFN down is
//    17,920 deep).  Every kPromote stages (32 of K each) the consumers
//    wait for their wgmma, add the accumulator into a second f32
//    accumulator on the CUDA cores (round to nearest) and start the next
//    range afresh (the first product's scale-d 0): the tensor cores then
//    sum at most 32 * kPromote of K.  The second accumulator is why BN
//    stops at 128: ptxas holds every thread of a 384-thread CTA to 168
//    registers whatever setmaxnreg gives the consumers later, and 64 +
//    64 sums, 16 fragment and 8 A registers a thread leave the rest for
//    addresses and the loop.
//  * Ragged edges cost nothing in the main loop: TMA zero-fills rows,
//    columns and K beyond the tensors; the epilogue stores only inside
//    M x N.
//  * lo_terms = 0 zeroes the lo words (1xTF32): a control that the small
//    terms are real, never a route.
//  * No persistence, no clusters, no TMA store yet.

#include <cuda.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;         // output rows per CTA
constexpr int kBK = 32;          // K per stage: one 128-byte f32 swizzle row
constexpr int kStages = 4;       // TMA ring: an A and a w tile each
constexpr int kBStages = 2;      // ring of the hi/lo B tiles
constexpr int kConsumers = 2;    // warpgroups of 64 rows each
constexpr int kTransposers = 3;  // producer-warpgroup warps rewriting w
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 16;      // row tiles a raster group sweeps first
// stages the tensor cores sum before the consumers promote their sums
// into the CUDA cores' (0: never): the wrapper's TF32_PROMOTE, chosen by
// the sweep of launch/tf32_promote.py, which builds copies of this
// source at other values
constexpr int kPromote = 2;

template <int BN>
struct Smem {
  static constexpr int kA = kBM * kBK * 4;         // bytes of one A tile
  static constexpr int kW = BN * kBK * 4;          // one w tile as TMA brings it
  static constexpr int kStage = kA + kW;
  static constexpr int kBt = BN * kBK * 4;         // one hi or lo B tile
  // 1024 bytes of slack to align the rings to the swizzle's period, then
  // a full and an empty mbarrier per stage of each ring
  static constexpr int kBytes = 1024 + kStages * kStage + kBStages * 2 * kBt +
                                8 * 2 * (kStages + kBStages);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 128-byte swizzle of a shared-memory address: the 16-byte chunk
// (bits 4-6) XOR the 128-byte row within the 1024-byte atom (bits 7-9)
__device__ __forceinline__ uint32_t swz(uint32_t a) {
  return a ^ ((a >> 3) & 0x70u);
}

__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// word i of v (i a constant once the loops unroll: no local memory)
__device__ __forceinline__ float word(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void sts4(uint32_t a, const uint32_t* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// the split of v: hi its top 19 bits (sign, exponent, 10 mantissa bits:
// a TF32 value exactly), lo = v - hi, exact in f32; mask 0 drops lo (the
// 1xTF32 control)
__device__ __forceinline__ void split_tf32(float v, uint32_t mask,
                                           uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & mask;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of `bar` with this parity has completed; a wait
// that never ends traps, so a fault ends the launch with an error
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 28)) __trap();
}

// one 2-D TMA box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// make this thread's shared-memory writes visible to wgmma (the async
// proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor, K-major with the 128-byte
// swizzle: 8 rows of 128 bytes an atom (stride offset 1024), the leading
// offset unused; a k8 step 32 bytes further along the row
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// tie registers that an in-flight wgmma reads or writes to this point of
// the program: the wait above has no register operands, so without this
// the compiler may move plain arithmetic on the accumulators (the
// promotion's adds, the epilogue's) or the next fragments' split above
// it, onto registers the tensor cores still own
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 f32) = A (64 x 8 tf32, registers) B (8 x 64 tf32, K-major in
// shared memory, 128-byte swizzle) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 128 f32) = A (64 x 8 tf32, registers) B (8 x 128 tf32, K-major
// in shared memory, 128-byte swizzle) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, const uint32_t* a,
                                           uint64_t db, int acc) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, db, acc);
  else
    wgmma_n128(d, a, db, acc);
}

__device__ __forceinline__ void store2(float* c, int row, int col, float v0,
                                       float v1, int M, int N, int pairs) {
  if (row >= M) return;
  float* p = c + static_cast<size_t>(row) * N + col;
  if (pairs && col + 1 < N) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < N) p[0] = v0;
    if (col + 1 < N) p[1] = v1;
  }
}

// BN: output columns per CTA; KMAJOR_B: w is K-major ((N, K) rows of K in
// memory) rather than N-major ((K, N) rows of N)
template <int BN, bool KMAJOR_B>
__global__ void __launch_bounds__(kThreads, 1)
matmul_lb_sm90_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           float* __restrict__ c, int M, int N, int K,
                           uint32_t lo_mask) {
  extern __shared__ uint8_t smem_raw[];
  using S = Smem<BN>;
  // from a 1024-byte line: the TMA ring (per stage the A tile, then the w
  // tile), the B ring (per stage the hi tile, then the lo tile), then the
  // mbarriers; every tile a multiple of 1024 bytes
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t b_ring = ring + kStages * S::kStage;
  const uint32_t bars = b_ring + kBStages * 2 * S::kBt;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto bfull = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto bempty = [&](int s) {
    return bars + 8 * (2 * kStages + kBStages + s);
  };

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // grouped raster: row tile fastest within a group of kGroupM
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + BN - 1) / BN;
  const int group = blockIdx.x / (kGroupM * tiles_n);
  const int first_m = group * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x - group * kGroupM * tiles_n;
  const int m0 = (first_m + in_group % rows) * kBM;
  const int n0 = (in_group / rows) * BN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4 + kTransposers);
    }
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(bfull(s), kTransposers);
      mbar_init(bempty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int warp = threadIdx.x / 32;
    if (warp == 0) {
      // the producer: one thread keeps the TMA ring full; the first pass
      // finds every stage empty (the parity of the phase before the first)
      if (lane != 0) return;
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty(s), phase ^ 1);
        const uint32_t a_dst = ring + s * S::kStage;
        const uint32_t w_dst = a_dst + S::kA;
        mbar_expect_tx(full(s), S::kStage);
        const int k0 = kt * kBK;
        tma_load(a_dst, &map_a, full(s), k0, m0);
        if constexpr (KMAJOR_B) {
          tma_load(w_dst, &map_b, full(s), k0, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 32; ++j)
            tma_load(w_dst + j * 32 * kBK * 4, &map_b, full(s), n0 + 32 * j,
                     k0);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // the transposers: per stage, the w tile -> hi and lo [n][32 words]
    // (K-major), word q of 16-byte chunk r of a row holding K element
    // r + 8q (the order the consumers' A fragments read).  A unit is 32
    // columns (a lane a column) and half of the chunks (r = 4hf .. 4hf + 3,
    // elements 4hf + j + 8q): 16 words in, four 16-byte stores each of hi
    // and lo (8 lanes, 8 rows of an atom: no conflict)
    const int tw = warp - 1;
    int s = 0, bs = 0;
    uint32_t phase = 0, bphase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full(s), phase);
      mbar_wait(bempty(bs), bphase ^ 1);
      const uint32_t src = ring + s * S::kStage + S::kA;
      const uint32_t dst = b_ring + bs * 2 * S::kBt;
      for (int u = tw; u < (BN / 32) * 2; u += kTransposers) {
        const int nb = u / 2, hf = u % 2;
        const int n = nb * 32 + lane;
        float v[4][4];   // v[j][q]: K element 4hf + j + 8q of column n
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (KMAJOR_B) {
            // row n of the tile: 16-byte chunk hf + 2q is elements
            // 4hf + 8q .. + 3
            const float4 w4 = lds4(swz(src + n * 128 + (hf + 2 * q) * 16));
            v[0][q] = w4.x;
            v[1][q] = w4.y;
            v[2][q] = w4.z;
            v[3][q] = w4.w;
          } else {
            // box nb: K row e, column lane
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j][q] = lds(swz(src + nb * 32 * kBK * 4 +
                                (4 * hf + j + 8 * q) * 128 + lane * 4));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(v[j][q], lo_mask, hi[q], lo[q]);
          const uint32_t d = dst + n * 128 + (((4 * hf + j) ^ (n % 8)) << 4);
          sts4(d, hi);
          sts4(d + S::kBt, lo);
        }
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty(s));
        mbar_arrive(bfull(bs));
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
      if (++bs == kBStages) {
        bs = 0;
        bphase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int cw = wg - 1;   // this consumer's 64 rows: 64*cw ..
  const int wrow = 16 * ((threadIdx.x % 128) / 32);  // this warp's 16
  // this thread's rows r0 = cw*64 + wrow + lane/4 and r0 + 8 of the A
  // tile, words [8c, 8c + 8) of each: two 16-byte chunks a row
  const int cq = lane % 4;
  const uint32_t a_row0 = (cw * 64 + wrow + lane / 4) * 128;
  // zeroed by an opaque move: a plain 0.f assignment lets the compiler
  // fold the zeros into the first group and serialize every wgmma
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    asm volatile("mov.b32 %0, 0;\n" : "=f"(acc[i]));
    sum[i] = 0.f;
  }

  // A fragments in two buffers across k8 steps: [hi a0..a3, lo a0..a3]
  uint32_t af[2][8];
  int s = 0, bs = 0, prev_bs = 0, since = 0;
  uint32_t phase = 0, bphase = 0;
  int keep = 0;   // 0: the next product starts a range afresh
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(full(s), phase);
    mbar_wait(bfull(bs), bphase);
    const uint32_t at = ring + s * S::kStage + a_row0 + cq * 32;
    const uint32_t bt = b_ring + bs * 2 * S::kBt;
    float4 x[2];   // rows r0, r0 + 8: words 8c + 4h .. + 3 of half h
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const int h = kk / 2, f = kk % 2;
      if (f == 0) {
        x[0] = lds4(swz(at + h * 16));
        x[1] = lds4(swz(at + 8 * 128 + h * 16));
        if (h == 1) {
          // every A word of this stage is loaded: the stage is free for
          // the producer once the transposers are done with it.  The
          // loads' values are not used yet, so nothing has waited for
          // them: without the proxy fence the next TMA write into the
          // stage (the async proxy) could land before they are served
          // (seen on the card as whole output rows changing from launch
          // to launch)
          fence_async_shared();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(s));
        }
      }
      // a0 (row r0, column c), a1 (r0 + 8, c), a2 (r0, c + 4), a3 (r0 + 8,
      // c + 4): words 2kk and 2kk + 1 of the thread's eight
      split_tf32(word(x[0], 2 * f), lo_mask, af[f][0], af[f][4]);
      split_tf32(word(x[1], 2 * f), lo_mask, af[f][1], af[f][5]);
      split_tf32(word(x[0], 2 * f + 1), lo_mask, af[f][2], af[f][6]);
      split_tf32(word(x[1], 2 * f + 1), lo_mask, af[f][3], af[f][7]);
      const uint64_t dhi = gmma_desc(bt + kk * 32);
      const uint64_t dlo = gmma_desc(bt + S::kBt + kk * 32);
      wgmma_fence();
      wgmma_tile<BN>(acc, &af[f][4], dhi, keep);   // lo * hi
      wgmma_tile<BN>(acc, &af[f][0], dlo, 1);      // hi * lo
      wgmma_tile<BN>(acc, &af[f][0], dhi, 1);      // hi * hi
      wgmma_commit();
      keep = 1;
      // this step alone in flight: the other buffer's fragments may be
      // overwritten; at a stage's first step the last of the stage
      // before has retired, and its B tiles are free
      wgmma_wait<1>();
      fence_regs<8>(af[f ^ 1]);
      if (kk == 0 && kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bempty(prev_bs));
      }
    }
    prev_bs = bs;
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
    if (++bs == kBStages) {
      bs = 0;
      bphase ^= 1;
    }
    if (kPromote > 0 && ++since == kPromote && kt + 1 < nk) {
      // promote the tensor cores' range into the CUDA cores' sums
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
      since = 0;
      keep = 0;
    }
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);

  // thread t of warp w holds rows 16w + t/4 (+8) and columns 8j + 2(t%4)
  // (+1) of its 64 x BN fragment
  const int t = threadIdx.x % 128;
  const int row = m0 + cw * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int col = n0 + 2 * (t % 4);
  const int pairs = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    store2(c, row, col + 8 * j, sum[4 * j] + acc[4 * j],
           sum[4 * j + 1] + acc[4 * j + 1], M, N, pairs);
    store2(c, row + 8, col + 8 * j, sum[4 * j + 2] + acc[4 * j + 2],
           sum[4 * j + 3] + acc[4 * j + 3], M, N, pairs);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call; the library links no libcuda,
// so it is fetched from the runtime once
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D f32 map: `inner` x `outer` elements, rows `pitch` elements apart,
// boxes of box_inner x box_outer, 128-byte swizzle, zero fill
int make_map(CUtensorMap* map, const void* base, uint64_t inner,
             uint64_t outer, uint64_t pitch, uint32_t box_inner,
             uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch * 4};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int BN, bool KMAJOR_B>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, void* c,
                   int M, int N, int K, uint32_t lo_mask,
                   cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_lb_sm90_tf32_kernel<BN, KMAJOR_B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BN>::kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int grid = ((N + BN - 1) / BN) * ((M + kBM - 1) / kBM);
  matmul_lb_sm90_tf32_kernel<BN, KMAJOR_B>
      <<<grid, kThreads, Smem<BN>::kBytes, stream>>>(
          ma, mb, static_cast<float*>(c), M, N, K, lo_mask);
  return cudaGetLastError();
}

static_assert(Smem<128>::kBytes <= 232448, "rings exceed shared memory");

}  // namespace

// a: (M, K) f32 rows lda elements apart; b: w as (K, N) rows ldb apart
// (b_kmajor 0) or as (N, K) rows ldb apart (b_kmajor 1); c: contiguous
// (M, N) f32.  Bases 16-byte aligned, pitches multiples of 4 elements
// (the wrapper's route checks both).  bn: 64 or 128 output columns a
// CTA; lo_terms = 0 drops the lo words (1xTF32, a control).  Returns a
// CUDA error code, or 1000 + the CUresult of a refused tensor map, or -1
// if the driver has no cuTensorMapEncodeTiled.
extern "C" int matmul_lb_sm90_tf32_forward(const void* a, const void* b,
                                           void* c, int M, int N, int K,
                                           int lda, int ldb, int bn,
                                           int b_kmajor, int lo_terms,
                                           void* stream) {
  if (M < 1 || N < 1 || K < 1 || (bn != 64 && bn != 128) ||
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + bn - 1) / bn) >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  int err = make_map(&ma, a, K, M, lda, kBK, kBM);
  if (err) return err;
  if (b_kmajor)
    err = make_map(&mb, b, K, N, ldb, kBK, bn);
  else
    err = make_map(&mb, b, N, K, ldb, 32, kBK);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = lo_terms ? 0xffffffffu : 0u;
  cudaError_t e;
  if (bn == 64)
    e = b_kmajor ? launch<64, true>(ma, mb, c, M, N, K, mask, s)
                 : launch<64, false>(ma, mb, c, M, N, K, mask, s);
  else
    e = b_kmajor ? launch<128, true>(ma, mb, c, M, N, K, mask, s)
                 : launch<128, false>(ma, mb, c, M, N, K, mask, s);
  return static_cast<int>(e);
}

extern "C" const char* matmul_lb_sm90_tf32_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
