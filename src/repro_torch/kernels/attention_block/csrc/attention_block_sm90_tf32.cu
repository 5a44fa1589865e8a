// Blocked (flash-style) attention forward in f32 on Hopper's tensor
// cores (sm_90a), in 3xTF32: f32 q, k, v in, f32 scores, softmax state
// and output sums, f32 out.  Causal and sliding-window masks,
// grouped-query heads.
//
// Replaces, with csrc/attention_block_sm90.cu (bf16) and
// csrc/attention_block.cu (which keeps the head dims TMA cannot describe
// and those above 128 in f32), the TPU kernel `_attn_kernel` launched by
// `attention_call` (src/repro/kernels/attention_block/kernel.py:22, :63).
// It computes the same function; it is not a block-by-block copy.
//
// Layout: q (B*H, Sq, hd); k, v (B*KV, Skv, hd); out like q, all
// contiguous f32.  Query head bh reads kv head bh / groups.
//
// What bounds it on this card.  Per unmasked (query, key) pair the work
// is 4*hd operations against q, k, v and out read or written once: at
// the configs' sequence lengths hundreds of operations per byte, so the
// operations bound it.  On FMA (67 TFLOP/s) no kernel gets under 8.72 ms
// for phi3-medium-14b's and mixtral-8x7b's attention.  TF32 on the
// tensor cores runs at 495 TFLOP/s but keeps 10 mantissa bits; 3xTF32
// splits each word v into hi and lo and sums lo*hi + hi*lo + hi*hi (lo*lo,
// about 2^-20 of a product, is dropped): close to f32 accuracy at a third
// of the TF32 rate, a bound of 3.54 ms for the same work.
//
// What the design does about it (csrc/attention_block_sm90.cu's
// skeleton, with csrc/matmul_lb_sm90_tf32.cu's 3xTF32 machinery).
//  * The CTA.  128 query rows of one head: two consumer warpgroups of 64
//    rows, and a producer warpgroup whose warp 0 issues TMA and whose
//    three other warps split and transpose.  The longest query tiles
//    launch first (tile rank slowest, heads fastest).
//  * Two rings of kStages stages, each stage 32 keys (a 64-key skip tile
//    in two).  The raw ring holds a K and a V tile as TMA brings them
//    (32-column boxes, 128-byte swizzle; GQA through a 3-D map over (hd,
//    S, heads)).  The split ring holds what the producer warps make of
//    them: K lo, and V^T hi and lo.  Q (128 rows) is loaded once.
//  * S = Q K^T: TF32 wgmma reads shared memory K-major only, and K's
//    natural (key, hd) rows are the K-major B operand.  The producer
//    warps overwrite each K word with its hi (its top 19 bits, so the
//    tensor cores read it unchanged whether they truncate or round an
//    operand's low bits) and write lo = k - hi beside it, chunk for
//    chunk.  Q is the register A operand: per k8 step each thread loads
//    its four words (rows r0, r0 + 8, columns 8kk + c, 8kk + c + 4),
//    splits them, and issues three wgmma m64n32k8 into the score
//    accumulator; kSGroup steps a commit group, fragments double-
//    buffered with one group in flight while the next is loaded.
//    Holding Q's hi and lo fragments over the sweep would take 128
//    registers a thread at hd 128, and a Q lo tile 64 KB.
//  * Online softmax in the accumulator registers in the exp2 domain
//    (row max and sum over the 4 lanes that share a row), as the bf16
//    kernel.
//  * O += P V: P is the register A operand, taken in place from the
//    score registers: k8 step j passes sc[4j], sc[4j + 2], sc[4j + 1],
//    sc[4j + 3], keys 8j + 2c and 8j + 2c + 1, so the K order inside a
//    step is permuted.  V's (key, hd) rows are MN-major, which TF32
//    wgmma cannot read: the producer warps rewrite each V tile as V^T,
//    one 128-byte row of 32 keys per hd column in that permuted order
//    (chunk r holds keys 8(r/2) + r%2 + 2q), split into hi and lo tiles,
//    a lane a column: 4-byte loads along a key row, 16-byte stores at the
//    swizzled chunk (both conflict-free).
//  * Promotion.  The tensor cores' f32 sums truncate, so they drift with
//    the length of the range they sum; O gathers 12 products a sub-tile
//    over up to 128 sub-tiles at 4096 keys.  The numpy model
//    (tests/test_torch_attention_tc.py) at 4096 keys errs 4.2e-5 of max
//    |exact| with O summed on the tensor cores throughout, 2.6e-6 with
//    each sub-tile's P V summed afresh and added on the CUDA cores: so P V
//    runs into a zeroed accumulator and O = O * alpha + (P V) is one fma
//    a word.  The second accumulator is why P V runs in two column halves
//    (n = kPart = HD / 2): ptxas holds a 384-thread CTA to 168 registers
//    a thread, and O (HD / 2), a half's sums (HD / 4) and P's fragments
//    (32) take 128 of them (at HD 128 it still spills 188 bytes).
//  * Masks as in the bf16 kernel: a query tile visits only
//    key_tile_range's tiles (mirrored in kernel.py), a consumer skips the
//    ones that hold no pair for its rows and the sub-tiles past Skv, and
//    masks are applied only on boundary sub-tiles.  A masked score is
//    the finite -1e30 of the reference (a row with no unmasked key gets
//    the mean of V over the Skv keys), a key at k >= Skv does not exist
//    (-inf).
//  * Head dims: instantiated at widths HD of 64, 96 and 128 (the plan in
//    kernel.py refuses 256: Q and the rings would not fit).  A head dim hd
//    (a multiple of 4, hd <= 128) runs at the next width: TMA zero-fills
//    the columns from hd to the boxes' end.  The scale is 1/sqrt(hd).
//  * Every shared-memory offset comes from the wrapper's plan
//    (sm90_tf32_plan) and is checked here against the kernel's sizes.
//  * Controls, never routes: lo_terms = 0 zeroes every lo word (1xTF32);
//    v_key_off = 1 has the transposers read V one key off.
//  * Log-sum-exp, where the caller passes an lse buffer (f32, (B*H,
//    Sq)): the first lane of each row of a consumer warpgroup writes
//    ln 2 * (m + log2 l) from its exp2-domain max m and sum l, or -inf
//    for a row with no unmasked key; O is computed and stored as without
//    it.

#include <cuda.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBQW = 64;          // query rows per consumer warpgroup
constexpr int kConsumers = 2;     // consumer warpgroups per CTA
constexpr int kBQ = kBQW * kConsumers;   // query rows per CTA
constexpr int kBKV = 64;          // keys per skip tile (key_tile_range)
constexpr int kBK = 32;           // keys per ring stage
constexpr int kStages = 2;        // stages of each ring
constexpr int kTransposers = 3;   // producer-warpgroup warps splitting K, V
constexpr int kThreads = 128 * (1 + kConsumers);
// k8 steps of S = Q K^T a wgmma group holds (two groups in flight),
// chosen by the sweep of launch/attention_tf32_variants.py, which builds
// copies of this source at other values
constexpr int kSGroup = 2;
constexpr float kMasked = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int kBoxes = HD / 32;     // 32-column TMA boxes
  static constexpr int kQ = kBQ * HD * 4;     // bytes of the Q tile
  static constexpr int kTile = kBK * HD * 4;  // a 32-key K, V, K lo, V^T tile
  static constexpr int kRaw = 2 * kTile;      // raw stage: K (hi in place), V
  static constexpr int kSplit = 3 * kTile;    // split stage: K lo, V^T hi, lo
  static constexpr int kBars = 8 * (1 + 4 * kStages);
  // O columns a P V product sums before its promotion into O: halves
  // (the same sweep's choice; parts of 32 spill more)
  static constexpr int kPart = HD / 2;
};

struct Geom {
  int BH, Sq, Skv, hd, groups, window, causal, nqt;
  float scale_log2;   // 1/sqrt(hd) * log2(e)
  float* lse;         // (BH, Sq) f32 log-sum-exp, or nullptr
};

// the natural log-sum-exp of a row from its exp2-domain max and sum;
// -inf where no key was unmasked
__device__ __forceinline__ float row_lse(float m, float l) {
  return m <= kMasked ? -INFINITY
                      : 0.6931471805599453f * (m + log2f(l));
}

// offsets from the 1024-byte-aligned base (the wrapper's plan), and the
// controls
struct Layout {
  uint32_t raw, split, bars;
  int v_key_off;
  uint32_t lo_mask;
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

// one 3-D TMA box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// make this thread's shared-memory writes visible to wgmma and TMA (the
// async proxy), and order its plain reads of a stage before TMA's next
// write into it
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
// the compiler may move plain arithmetic on the accumulators, or the
// reuse of a fragment's registers, above it
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

// registers zeroed by an opaque move: a plain 0.f lets the compiler fold
// the zeros into the first wgmma and serialize every one after it
template <int N>
__device__ __forceinline__ void opaque_zero(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("mov.b32 %0, 0;\n" : "=f"(r[i]));
}

// d (64 x 32 f32) = A (64 x 8 tf32, registers) B (8 x 32 tf32, K-major in
// shared memory, 128-byte swizzle) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 48 f32) = A (64 x 8 tf32, registers) B (8 x 48 tf32, K-major in
// shared memory, 128-byte swizzle) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_n48(float* d, const uint32_t* a,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
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

// one k8 step of a P V column part (n = N)
template <int N>
__device__ __forceinline__ void part_step(float* d, const uint32_t* a,
                                          uint64_t db, int acc) {
  static_assert(N == 32 || N == 48 || N == 64, "no wgmma for this part");
  if constexpr (N == 32)
    wgmma_n32(d, a, db, acc);
  else if constexpr (N == 48)
    wgmma_n48(d, a, db, acc);
  else
    wgmma_n64(d, a, db, acc);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_sm90_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           float* __restrict__ out, const Geom g,
                           const Layout lay) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  // from a 1024-byte line (the swizzle's period): Q, the raw ring (per
  // stage K, then V), the split ring (per stage K lo, V^T hi, V^T lo),
  // the mbarriers; offsets from the wrapper's plan
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t raw = base + lay.raw;
  const uint32_t split = base + lay.split;
  const uint32_t bars = base + lay.bars;
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto bfull = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto bempty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // longest query tiles first: tile rank slowest, heads fastest
  const int bh = blockIdx.x % g.BH;
  const int qt = g.nqt - 1 - static_cast<int>(blockIdx.x / g.BH);
  const int q0 = qt * kBQ;
  const int kvh = bh / g.groups;
  int lo, hi;
  key_tile_range(q0, min(q0 + kBQ, g.Sq), g.Skv, g.window, g.causal, kBKV,
                 &lo, &hi);
  // the ring stages: each visited 64-key tile as two 32-key sub-tiles
  const int u0 = 2 * lo, u1 = 2 * hi;

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4 + kTransposers);
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
      // the producer: one thread loads Q once and keeps the raw ring
      // full; the first pass finds every stage empty (the parity of the
      // phase before the first)
      if (lane != 0) return;
      mbar_expect_tx(qfull, C::kQ);
#pragma unroll
      for (int b = 0; b < C::kBoxes; ++b)
        tma_load(s_q + b * kBQ * 128, &map_q, qfull, 32 * b, q0, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int u = u0; u < u1; ++u) {
        mbar_wait(empty(s), phase ^ 1);
        const uint32_t k_dst = raw + s * C::kRaw;
        const uint32_t v_dst = k_dst + C::kTile;
        if (u * kBK >= g.Skv) {
          // a sub-tile past Skv (the second half of a last tile): nothing
          // to load, and nobody reads it
          mbar_arrive(full(s));
        } else {
          mbar_expect_tx(full(s), C::kRaw);
#pragma unroll
          for (int b = 0; b < C::kBoxes; ++b) {
            tma_load(k_dst + b * kBK * 128, &map_k, full(s), 32 * b,
                     u * kBK, kvh);
            tma_load(v_dst + b * kBK * 128, &map_v, full(s), 32 * b,
                     u * kBK, kvh);
          }
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // the transposers: per sub-tile, K -> hi in place and lo beside it
    // (a 16-byte chunk a lane, the same swizzled position), and V -> V^T
    // hi and lo (unit (box b, chunk r): a lane a column n = 32b + lane,
    // four keys 8(r/2) + r%2 + 2q of it, stored as chunk r of row n)
    const int tw = warp - 1;
    int s = 0;
    uint32_t phase = 0;
    for (int u = u0; u < u1; ++u) {
      mbar_wait(full(s), phase);
      mbar_wait(bempty(s), phase ^ 1);
      const uint32_t k_t = raw + s * C::kRaw;
      const uint32_t v_t = k_t + C::kTile;
      const uint32_t k_lo = split + s * C::kSplit;
      const uint32_t vt_hi = k_lo + C::kTile;
      const uint32_t vt_lo = vt_hi + C::kTile;
      const int todo = u * kBK < g.Skv;   // else a sub-tile nobody reads
      for (int i = tw * 32 + lane; todo && i < C::kTile / 16;
           i += kTransposers * 32) {
        const float4 w = lds4(k_t + 16 * i);
        uint32_t h[4], l[4];
        split_tf32(w.x, lay.lo_mask, h[0], l[0]);
        split_tf32(w.y, lay.lo_mask, h[1], l[1]);
        split_tf32(w.z, lay.lo_mask, h[2], l[2]);
        split_tf32(w.w, lay.lo_mask, h[3], l[3]);
        sts4(k_t + 16 * i, h);
        sts4(k_lo + 16 * i, l);
      }
      for (int unit = tw; todo && unit < C::kBoxes * 8;
           unit += kTransposers) {
        const int b = unit / 8, r = unit % 8;
        const int n = 32 * b + lane;
        uint32_t h[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int key = (8 * (r / 2) + r % 2 + 2 * q + lay.v_key_off) &
                          (kBK - 1);
          split_tf32(lds(swz(v_t + b * kBK * 128 + key * 128 + lane * 4)),
                     lay.lo_mask, h[q], l[q]);
        }
        const uint32_t d = n * 128 + ((r ^ (n % 8)) << 4);
        sts4(vt_hi + d, h);
        sts4(vt_lo + d, l);
      }
      // the writes to the async proxy, the reads before TMA's next write
      fence_async_shared();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty(s));
        mbar_arrive(bfull(s));
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int cw = wg - 1;           // this consumer's rows: 64*cw ..
  const int warp = (threadIdx.x % 128) / 32;
  const int lr0 = cw * kBQW + 16 * warp + lane / 4;   // row in the Q tile
  const int r0 = q0 + lr0;         // this thread's two rows
  const int r1 = r0 + 8;
  const int c = lane % 4;
  const int c2 = 2 * c;            // its key (and O column) offset in 8
  const int qw0 = q0 + cw * kBQW;
  int lo_w = lo, hi_w = lo;        // rows past Sq visit nothing
  if (qw0 < g.Sq)
    key_tile_range(qw0, min(qw0 + kBQW, g.Sq), g.Skv, g.window, g.causal,
                   kBKV, &lo_w, &hi_w);
  const int q_last = min(qw0 + kBQW, g.Sq) - 1;
  // word 8kk + c of rows lr0 and lr0 + 8 lies in box kk / 4, 32 (kk % 4)
  // bytes into the row
  const uint32_t q_row = s_q + lr0 * 128 + c * 4;

  float o[HD / 2];
  float sc[kBK / 2];
  float pv[C::kPart / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qfull, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int u = u0; u < u1; ++u) {
    mbar_wait(bfull(s), phase);
    const int k0 = u * kBK;
    if (u / 2 >= lo_w && u / 2 < hi_w && k0 < g.Skv) {
      const uint32_t k_hi = raw + s * C::kRaw;
      const uint32_t k_lo = split + s * C::kSplit;
      const uint32_t vt_hi = k_lo + C::kTile;
      const uint32_t vt_lo = vt_hi + C::kTile;

      // S = Q K^T: k8 steps along hd, Q's fragments split in registers,
      // double-buffered with one step in flight; the sums start afresh
      // (scale-d 0), and the opaque zero ends the last sub-tile's scores'
      // lives (the wgmma's operands are read-write)
      opaque_zero<kBK / 2>(sc);
      uint32_t af[2][8 * kSGroup];
#pragma unroll
      for (int gi = 0; gi < HD / 8 / kSGroup; ++gi) {
        const int f = gi & 1;
#pragma unroll
        for (int st = 0; st < kSGroup; ++st) {
          const int kk = gi * kSGroup + st;
          uint32_t* fr = af[f] + 8 * st;
          const uint32_t a = q_row + (kk / 4) * kBQ * 128 + (kk % 4) * 32;
          // a0 (r0, c), a1 (r1, c), a2 (r0, c + 4), a3 (r1, c + 4)
          split_tf32(lds(swz(a)), lay.lo_mask, fr[0], fr[4]);
          split_tf32(lds(swz(a + 8 * 128)), lay.lo_mask, fr[1], fr[5]);
          split_tf32(lds(swz(a + 16)), lay.lo_mask, fr[2], fr[6]);
          split_tf32(lds(swz(a + 8 * 128 + 16)), lay.lo_mask, fr[3], fr[7]);
        }
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < kSGroup; ++st) {
          const int kk = gi * kSGroup + st;
          const uint32_t* fr = af[f] + 8 * st;
          const uint32_t kb = (kk / 4) * kBK * 128 + (kk % 4) * 32;
          const uint64_t dhi = gmma_desc(k_hi + kb);
          const uint64_t dlo = gmma_desc(k_lo + kb);
          wgmma_n32(sc, fr + 4, dhi, kk > 0);   // lo * hi
          wgmma_n32(sc, fr, dlo, 1);            // hi * lo
          wgmma_n32(sc, fr, dhi, 1);            // hi * hi
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<8 * kSGroup>(af[f ^ 1]);
      }
      wgmma_wait<0>();
      fence_regs<8 * kSGroup>(af[(HD / 8 / kSGroup - 1) & 1]);
      fence_regs<kBK / 2>(sc);
      // K's hi words are read: this warp releases the raw stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));

      // thread holds sc[4j + e] at (r0, key 8j + c2 + e) and sc[4j + 2 +
      // e] at (r1, the same key), e = 0, 1
      const bool edge =
          k0 + kBK > g.Skv || (g.causal && k0 + kBK - 1 > qw0) ||
          (g.window > 0 && static_cast<long long>(k0) <=
                               static_cast<long long>(q_last) - g.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + c2 + (e & 1);
            const int qp = e < 2 ? r0 : r1;
            const bool masked =
                (g.causal && kp > qp) ||
                (g.window > 0 && static_cast<long long>(kp) <=
                                     static_cast<long long>(qp) - g.window);
            float& v = sc[4 * j + e];
            v = kp >= g.Skv ? -INFINITY
                : masked    ? kMasked
                            : v * g.scale_log2;
          }
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] *= g.scale_log2;
      }

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // P in f32 for the row sums, then as hi + lo TF32 fragments of the
      // P V product taken in place: k8 step j passes sc[4j], sc[4j + 2],
      // sc[4j + 1], sc[4j + 3] as (r0, c), (r1, c), (r0, c + 4), (r1,
      // c + 4): keys 8j + 2c and 8j + 2c + 1, the order of V^T's rows
      uint32_t pf[kBK / 8][8];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p0 = exp2f(sc[4 * j] - mn0);
        const float p1 = exp2f(sc[4 * j + 1] - mn0);
        const float p2 = exp2f(sc[4 * j + 2] - mn1);
        const float p3 = exp2f(sc[4 * j + 3] - mn1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        split_tf32(p0, lay.lo_mask, pf[j][0], pf[j][4]);
        split_tf32(p2, lay.lo_mask, pf[j][1], pf[j][5]);
        split_tf32(p1, lay.lo_mask, pf[j][2], pf[j][6]);
        split_tf32(p3, lay.lo_mask, pf[j][3], pf[j][7]);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;

      // O = O alpha + P V, kPart columns (rows of V^T) at a time: the
      // part's sums start afresh on the tensor cores, then one fma a word
      // adds them to O on the CUDA cores (round to nearest)
#pragma unroll
      for (int pt = 0; pt < HD / C::kPart; ++pt) {
        opaque_zero<C::kPart / 2>(pv);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const uint32_t vb = pt * C::kPart * 128 + j * 32;
          const uint64_t dvh = gmma_desc(vt_hi + vb);
          const uint64_t dvl = gmma_desc(vt_lo + vb);
          part_step<C::kPart>(pv, pf[j] + 4, dvh, j > 0);   // lo * hi
          part_step<C::kPart>(pv, pf[j], dvl, 1);           // hi * lo
          part_step<C::kPart>(pv, pf[j], dvh, 1);           // hi * hi
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<C::kPart / 2>(pv);
        // the part's word 4i + e is O's word kPart/2 pt + 4i + e
#pragma unroll
        for (int i = 0; i < C::kPart / 8; ++i) {
          float* ow = o + pt * (C::kPart / 2) + 4 * i;
          ow[0] = fmaf(ow[0], a0, pv[4 * i]);
          ow[1] = fmaf(ow[1], a0, pv[4 * i + 1]);
          ow[2] = fmaf(ow[2], a1, pv[4 * i + 2]);
          ow[3] = fmaf(ow[3], a1, pv[4 * i + 3]);
        }
      }
      fence_regs<8 * (kBK / 8)>(&pf[0][0]);
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    // K lo and V^T are read: this warp releases the split stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bempty(s));
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }

  // the row sums over the 4 lanes of a row, then one store of O / l
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (g.lse != nullptr && c == 0) {
    if (r0 < g.Sq) g.lse[static_cast<size_t>(bh) * g.Sq + r0] = row_lse(m0, l0);
    if (r1 < g.Sq) g.lse[static_cast<size_t>(bh) * g.Sq + r1] = row_lse(m1, l1);
  }
  float* row0 = out + (static_cast<size_t>(bh) * g.Sq + r0) * g.hd;
  float* row1 = row0 + static_cast<size_t>(8) * g.hd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + c2;   // hd % 4 == 0: col + 1 < hd iff col < hd
    if (col >= g.hd) continue;
    if (r0 < g.Sq)
      *reinterpret_cast<float2*>(row0 + col) =
          make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < g.Sq)
      *reinterpret_cast<float2*>(row1 + col) =
          make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
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

// a 3-D f32 map over (hd, rows, heads) of a contiguous tensor, boxes of
// 32 columns (128 bytes) x box_rows rows of one head, 128-byte swizzle,
// zero fill
int make_map(CUtensorMap* map, const void* base, int hd, int rows,
             int heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 4,
                                 static_cast<cuuint64_t>(hd) * rows * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, Geom g,
           int raw_off, int split_off, int bars_off, int smem_bytes,
           Layout lay, cudaStream_t stream) {
  using C = Cfg<HD>;
  // the plan's offsets against this kernel's own sizes
  if (raw_off < C::kQ || raw_off % 1024 ||
      split_off < raw_off + kStages * C::kRaw || split_off % 1024 ||
      bars_off < split_off + kStages * C::kSplit || bars_off % 8 ||
      smem_bytes < 1024 + bars_off + C::kBars || smem_bytes > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  lay.raw = static_cast<uint32_t>(raw_off);
  lay.split = static_cast<uint32_t>(split_off);
  lay.bars = static_cast<uint32_t>(bars_off);
  g.nqt = (g.Sq + kBQ - 1) / kBQ;
  if (static_cast<long long>(g.nqt) * g.BH > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  const int kv_heads = g.BH / g.groups;
  int err = make_map(&mq, q, g.hd, g.Sq, g.BH, kBQ);
  if (!err) err = make_map(&mk, k, g.hd, g.Skv, kv_heads, kBK);
  if (!err) err = make_map(&mv, v, g.hd, g.Skv, kv_heads, kBK);
  if (err) return err;
  static int opted_in = 0;
  if (smem_bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_sm90_tf32_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem_bytes;
  }
  const unsigned grid = static_cast<unsigned>(g.nqt) * g.BH;
  attention_sm90_tf32_kernel<HD><<<grid, kThreads, smem_bytes, stream>>>(
      mq, mk, mv, static_cast<float*>(out), g, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (BH, Sq, hd), k, v (BH / groups, Skv, hd), out like q: contiguous
// f32, bases 16-byte aligned, hd % 4 == 0 (the wrapper's route checks
// both); width is the instantiated head dim hd runs at; raw_off,
// split_off, bars_off and smem_bytes are the wrapper's plan
// (sm90_tf32_plan); v_key_off (0) and lo_terms (1) are controls; lse is
// nullptr or an f32 (BH, Sq) buffer for each row's log-sum-exp.
// Returns a CUDA error code, or 1000 + the CUresult of a refused tensor
// map, or -1 if the driver has no cuTensorMapEncodeTiled.
extern "C" int attention_block_sm90_tf32_forward_lse(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int BH, int Sq,
    int Skv, int hd, int width, int groups, int window, int causal,
    int raw_off, int split_off, int bars_off, int smem_bytes, int v_key_off,
    int lo_terms, void* stream) {
  if (BH < 1 || Sq < 1 || Skv < 1 || groups < 1 || BH % groups ||
      hd < 1 || hd % 4 || hd > width || window < 0 || v_key_off < 0 ||
      v_key_off >= kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.BH = BH;
  g.Sq = Sq;
  g.Skv = Skv;
  g.hd = hd;
  g.groups = groups;
  g.window = window;
  g.causal = causal;
  // the reference's 1 / hd ** 0.5 of the real hd, in the exp2 domain
  g.scale_log2 = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)) *
                                    1.4426950408889634);
  g.lse = static_cast<float*>(lse);
  Layout lay;
  lay.v_key_off = v_key_off;
  lay.lo_mask = lo_terms ? 0xffffffffu : 0u;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64: return launch<64>(q, k, v, out, g, raw_off, split_off, bars_off, smem_bytes, lay, s);
    case 96: return launch<96>(q, k, v, out, g, raw_off, split_off, bars_off, smem_bytes, lay, s);
    case 128: return launch<128>(q, k, v, out, g, raw_off, split_off, bars_off, smem_bytes, lay, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the same without the log-sum-exp
extern "C" int attention_block_sm90_tf32_forward(
    const void* q, const void* k, const void* v, void* out, int BH, int Sq,
    int Skv, int hd, int width, int groups, int window, int causal,
    int raw_off, int split_off, int bars_off, int smem_bytes, int v_key_off,
    int lo_terms, void* stream) {
  return attention_block_sm90_tf32_forward_lse(
      q, k, v, out, nullptr, BH, Sq, Skv, hd, width, groups, window, causal,
      raw_off, split_off, bars_off, smem_bytes, v_key_off, lo_terms, stream);
}

extern "C" const char* attention_block_sm90_tf32_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
