// Blocked (flash-style) attention forward in bf16 on Hopper's tensor
// cores (sm_90a): bf16 q, k, v in, f32 scores, softmax state and
// output sums, the output rounded once to bf16.  Causal and
// sliding-window masks, grouped-query heads.
//
// Replaces, with csrc/attention_block.cu (which keeps f32, the bf16
// head dims TMA cannot describe and head dims above 256), the TPU
// kernel `_attn_kernel` launched by `attention_call`
// (src/repro/kernels/attention_block/kernel.py:22, :63).  It computes
// the same function; it is not a block-by-block copy.
//
// Layout: q (B*H, Sq, hd); k, v (B*KV, Skv, hd); out like q, all
// contiguous.  Query head bh reads kv head bh / groups.
//
// What bounds it on this card.  Per unmasked (query, key) pair the
// work is 4*hd operations against q, k, v and out read or written
// once: at the configs' sequence lengths over a thousand operations
// per byte, above the card's bf16 balance (about 295 per byte), so the
// tensor-core rate bounds it.
//
// What the design does about it.
//  * Only wgmma reaches the tensor-core rate.  A CTA owns 128 query
//    rows of one head (64 at HD 256): consumer warpgroups of 64 rows
//    each and one producer warp.  Per key tile of kBKV = 64 keys a
//    consumer computes S = Q K^T with wgmma m64n64k16 (Q and K read
//    from shared memory, K's natural (key, hd) rows as the K-major B
//    operand), runs the online softmax in the accumulator registers
//    (the row max and sum reduced across the 4 lanes that share a row),
//    converts P to bf16 in registers and issues O += P V with P as the
//    register A operand and V's (key, hd) tile as the MN-major B
//    operand.  O (64 x HD f32) and the row state stay in registers over
//    the whole sweep and are written once.
//  * Registers: a 384-thread CTA compiles to at most 168 a thread, so
//    at HD <= 128 two consumers hold O (HD/2), S (32) and P (32) in
//    that; at HD 256, whose O alone is 128 a thread, one consumer runs
//    in a 256-thread CTA (255 a thread).
//  * The producer issues TMA loads: Q once, then K and V tiles into a
//    ring of kStages stages guarded by "full" (transaction bytes) and
//    "empty" (one arrival per consumer warp) mbarriers, so the next
//    tiles arrive while this one is computed.  GQA reads kv head
//    bh / groups through a 3-D tensor map over (hd, S, heads).
//  * Masks cost little: a query tile visits only the key tiles that
//    hold an unmasked pair (key_tile_range, mirrored in kernel.py:
//    up to the diagonal under causal, from the first tile that reaches
//    q - window + 1 under a window), each consumer skips the tiles
//    that hold none for its own 64 rows, and masks are applied only on
//    the boundary tiles.  A tile that holds a row with no unmasked key
//    (Sq > Skv + window - 1) visits every key, as the reference's lax
//    semantics need (the mean of V over all Skv keys).
//  * The longest query tiles launch first (query tile rank slowest,
//    heads fastest), so the causal tail does not end on a half-empty
//    card.
//  * Head dims: instantiated at widths HD of 64, 80, 96, 128 and 256.
//    A head dim hd (hd * 2 a multiple of 16, hd <= 256) runs at the
//    next width: TMA zero-fills the columns from hd to the 64-column
//    boxes' end, which add nothing to a score and make O columns that
//    are never stored.  The scale is 1/sqrt(hd).
//
// Numerics: P enters P V as two bf16 terms, hi = bf16(P) and
// lo = bf16(P - hi), two wgmma per k16 step, so P keeps about 16 bits.
// P rounded once to bf16 (as most tensor-core flash attentions run)
// puts a 2^-9 relative error on each weight, which in a row with few
// effective keys (the first rows of a causal sequence) reaches several
// times the card gate's 1e-2 rms(out) where the rms is set by the many
// rows with thousands of keys: at S 4096 causal the single rounding
// misses the gate by 1.4-2x (on the card and in a CPU emulation); the
// split costs one more P V product per tile.  The row sum l is taken
// over the f32 P.  A masked score is the finite -1e30 of the reference
// (in the exp2 domain), a key at k >= Skv does not exist (-inf).
//
// Log-sum-exp.  Where the caller passes an lse buffer (f32, (B*H, Sq)),
// the first lane of each row writes the natural log of the row's sum
// over its unmasked keys, ln 2 * (m + log2 l) from the exp2-domain max m
// and sum l, or -inf for a row with no unmasked key (m is then the
// masked -1e30).  Shards of one row's keys merge through it.  O is
// computed and stored as without it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBQW = 64;                  // query rows per consumer
constexpr int kBKV = 64;                  // keys per tile
constexpr int kStages = 2;
constexpr float kMasked = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int kConsumers = HD > 128 ? 1 : 2;   // warpgroups
  static constexpr int kBQ = kBQW * kConsumers;   // query rows per CTA
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBoxes = (HD + 63) / 64;  // 64-column TMA boxes
  static constexpr int kQ = kBQ * 128 * kBoxes;     // bytes of the Q tile
  static constexpr int kKV = kBKV * 128 * kBoxes;   // of one K or V tile
  static constexpr int kStage = 2 * kKV;
  // 1024 bytes of slack to align the tiles to the swizzle's period
  static constexpr int kBytes =
      1024 + kQ + kStages * kStage + 8 * (1 + 2 * kStages);
};

static_assert(Cfg<256>::kBytes <= 232448, "tiles exceed shared memory");
static_assert(Cfg<128>::kBytes <= 232448, "tiles exceed shared memory");

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

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
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

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
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

// d (64 x 64 f32) = A (64 x 16, K-major, shared) B (16 x 64, K-major,
// shared) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16, bf16 registers) B (16 x 64, MN-major,
// shared)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80 f32) += A (64 x 16, bf16 registers) B (16 x 80, MN-major,
// shared)
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96 f32) += A (64 x 16, bf16 registers) B (16 x 96, MN-major,
// shared)
__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16, bf16 registers) B (16 x 128, MN-major,
// shared)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += A (64 x 16, bf16 registers) B (16 x 256, MN-major,
// shared)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x HD) += P V over one k16 step of keys
template <int HD>
__device__ __forceinline__ void value_step(float* o, const uint32_t* p,
                                           uint64_t dv) {
  if constexpr (HD == 64)
    wgmma_rs_n64(o, p, dv);
  else if constexpr (HD == 80)
    wgmma_rs_n80(o, p, dv);
  else if constexpr (HD == 96)
    wgmma_rs_n96(o, p, dv);
  else if constexpr (HD == 128)
    wgmma_rs_n128(o, p, dv);
  else
    wgmma_rs_n256(o, p, dv);
}

// a pair of P words as bf16 hi = bf16(p) and lo = bf16(p - hi), each
// packed first word low
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      __nv_bfloat16* __restrict__ out, const Geom g) {
  using C = Cfg<HD>;
  constexpr int BKV = kBKV;
  constexpr int kBQ = C::kBQ;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t ring = s_q + C::kQ;
  const uint32_t bars = ring + kStages * C::kStage;
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  // longest query tiles first: tile rank slowest, heads fastest
  const int bh = blockIdx.x % g.BH;
  const int qt = g.nqt - 1 - static_cast<int>(blockIdx.x / g.BH);
  const int q0 = qt * kBQ;
  const int kvh = bh / g.groups;
  int lo, hi;
  key_tile_range(q0, min(q0 + kBQ, g.Sq), g.Skv, g.window, g.causal, BKV,
                 &lo, &hi);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load; with two consumers its
    // warpgroup gives them its registers
    if constexpr (C::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qfull, C::kQ);
#pragma unroll
      for (int b = 0; b < C::kBoxes; ++b)
        tma_load(s_q + b * kBQ * 128, &map_q, qfull, 64 * b, q0, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int t = lo; t < hi; ++t) {
        // the first pass finds every stage empty (parity of the phase
        // before the first)
        mbar_wait(empty(s), phase ^ 1);
        const uint32_t k_dst = ring + s * C::kStage;
        const uint32_t v_dst = k_dst + C::kKV;
        mbar_expect_tx(full(s), C::kStage);
#pragma unroll
        for (int b = 0; b < C::kBoxes; ++b) {
          tma_load(k_dst + b * BKV * 128, &map_k, full(s), 64 * b, t * BKV,
                   kvh);
          tma_load(v_dst + b * BKV * 128, &map_v, full(s), 64 * b, t * BKV,
                   kvh);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (C::kConsumers == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;           // this consumer's rows: 64*cw ..
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32;
  const int lane = t128 % 32;
  const int qw0 = q0 + cw * kBQW;
  // this thread's two rows, and its key (and O column) offset in a
  // group of 8
  const int r0 = qw0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int c2 = 2 * (lane % 4);
  int lo_w = lo, hi_w = lo;        // rows past Sq visit nothing
  if (qw0 < g.Sq)
    key_tile_range(qw0, min(qw0 + kBQW, g.Sq), g.Skv, g.window, g.causal,
                   BKV, &lo_w, &hi_w);
  const int q_last = min(qw0 + kBQW, g.Sq) - 1;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qfull, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int t = lo; t < hi; ++t) {
    mbar_wait(full(s), phase);
    if (t >= lo_w && t < hi_w) {
      const uint32_t k_tile = ring + s * C::kStage;
      const uint32_t v_tile = k_tile + C::kKV;
      // S = Q K^T: k16 steps along hd, 4 to a 64-column box, 32 bytes
      // apart in the swizzled 128-byte row
      float sc[BKV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t box = kk / 4, step = (kk % 4) * 32;
        const uint64_t dq =
            gmma_desc(s_q + box * kBQ * 128 + cw * kBQW * 128 + step, 16,
                      1024);
        const uint64_t dk = gmma_desc(k_tile + box * BKV * 128 + step, 16,
                                      1024);
        wgmma_ss_n64(sc, dq, dk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // thread holds sc[4j + e] at (r0, key 8j + c2 + e) and
      // sc[4j + 2 + e] at (r1, the same key), e = 0, 1
      const int k0 = t * BKV;
      const bool edge =
          k0 + BKV > g.Skv || (g.causal && k0 + BKV - 1 > qw0) ||
          (g.window > 0 && static_cast<long long>(k0) <=
                               static_cast<long long>(q_last) - g.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
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
        for (int i = 0; i < BKV / 2; ++i) sc[i] *= g.scale_log2;
      }

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
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
      // P in f32 for the row sums, then as hi + lo bf16 terms in the
      // register A layout of the P V product: its k16 step kk takes
      // sc[8kk .. 8kk + 7] as 4 pairs
      uint32_t p_hi[BKV / 4], p_lo[BKV / 4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const float p0 = exp2f(sc[4 * j] - mn0);
        const float p1 = exp2f(sc[4 * j + 1] - mn0);
        const float p2 = exp2f(sc[4 * j + 2] - mn1);
        const float p3 = exp2f(sc[4 * j + 3] - mn1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        split_bf16(p0, p1, p_hi[2 * j], p_lo[2 * j]);
        split_bf16(p2, p3, p_hi[2 * j + 1], p_lo[2 * j + 1]);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      // O += P V: k16 steps along the keys, 16 rows of 128 bytes; V's
      // 64-column boxes BKV * 128 bytes apart (leading), 8-key groups
      // 1024 bytes apart (stride)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t dv = gmma_desc(v_tile + kk * 2048, BKV * 128, 1024);
        value_step<HD>(o, p_hi + 4 * kk, dv);
        value_step<HD>(o, p_lo + 4 * kk, dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    // this warp has read the stage: release it
    if (lane == 0) mbar_arrive(empty(s));
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
  if (g.lse != nullptr && c2 == 0) {
    if (r0 < g.Sq) g.lse[static_cast<size_t>(bh) * g.Sq + r0] = row_lse(m0, l0);
    if (r1 < g.Sq) g.lse[static_cast<size_t>(bh) * g.Sq + r1] = row_lse(m1, l1);
  }
  __nv_bfloat16* row0 = out + (static_cast<size_t>(bh) * g.Sq + r0) * g.hd;
  __nv_bfloat16* row1 = row0 + static_cast<size_t>(8) * g.hd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + c2;   // hd % 8 == 0: col + 1 < hd iff col < hd
    if (col >= g.hd) continue;
    if (r0 < g.Sq)
      *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < g.Sq)
      *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
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

// a 3-D bf16 map over (hd, rows, heads) of a contiguous tensor, boxes of
// 64 columns x box_rows rows of one head, 128-byte swizzle, zero fill
int make_map(CUtensorMap* map, const void* base, int hd, int rows,
             int heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(hd) * rows * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, Geom g,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  g.nqt = (g.Sq + C::kBQ - 1) / C::kBQ;
  if (static_cast<long long>(g.nqt) * g.BH > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  const int kv_heads = g.BH / g.groups;
  int err = make_map(&mq, q, g.hd, g.Sq, g.BH, C::kBQ);
  if (!err) err = make_map(&mk, k, g.hd, g.Skv, kv_heads, kBKV);
  if (!err) err = make_map(&mv, v, g.hd, g.Skv, kv_heads, kBKV);
  if (err) return err;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_sm90_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const unsigned grid = static_cast<unsigned>(g.nqt) * g.BH;
  attention_sm90_kernel<HD><<<grid, C::kThreads, C::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (BH, Sq, hd), k, v (BH / groups, Skv, hd), out like q: contiguous
// bf16, bases 16-byte aligned, hd % 8 == 0 (the wrapper's route checks
// both); width is the instantiated head dim hd runs at; lse is nullptr
// or an f32 (BH, Sq) buffer for each row's log-sum-exp.  Returns a CUDA
// error code, or 1000 + the CUresult of a refused tensor map, or -1 if
// the driver has no cuTensorMapEncodeTiled.
extern "C" int attention_block_sm90_forward_lse(const void* q, const void* k,
                                                const void* v, void* out,
                                                void* lse, int BH, int Sq,
                                                int Skv, int hd, int width,
                                                int groups, int window,
                                                int causal, void* stream) {
  if (BH < 1 || Sq < 1 || Skv < 1 || groups < 1 || BH % groups ||
      hd < 1 || hd % 8 || hd > width || window < 0)
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
  g.scale_log2 =
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd)) * 1.4426950408889634);
  g.lse = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64: return launch<64>(q, k, v, out, g, s);
    case 80: return launch<80>(q, k, v, out, g, s);
    case 96: return launch<96>(q, k, v, out, g, s);
    case 128: return launch<128>(q, k, v, out, g, s);
    case 256: return launch<256>(q, k, v, out, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the same without the log-sum-exp
extern "C" int attention_block_sm90_forward(const void* q, const void* k,
                                            const void* v, void* out, int BH,
                                            int Sq, int Skv, int hd,
                                            int width, int groups,
                                            int window, int causal,
                                            void* stream) {
  return attention_block_sm90_forward_lse(q, k, v, out, nullptr, BH, Sq, Skv,
                                          hd, width, groups, window, causal,
                                          stream);
}

extern "C" const char* attention_block_sm90_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
