// Batch-folded NHWC convolution in f32 on Hopper's tensor cores (sm_90a),
// stride 1, in 3xTF32, with the fused bias -> residual -> ReLU -> 2x2
// max-pool epilogue: f32 in, f32 sums, f32 out.
//
// Replaces, with csrc/conv_lb_sm90.cu (bf16) and csrc/conv_lb.cu (which
// keeps strides, lhs dilation and the layouts TMA cannot describe), the
// TPU kernel `_conv_kernel` launched by `conv_lb_call`
// (src/repro/kernels/conv_lb/kernel.py:116, :177).  It computes the same
// function; it is not a block-by-block copy of it.
//
// What bounds it on this card.  VGG's 3x3 layers do 2*9*Ci operations
// per output word against a few bytes moved per word: hundreds of
// operations per byte from Ci = 64 on, so the arithmetic bounds them.  On
// FMA (67 TFLOP/s) the 13 VGG16/224 convs at batch 8 take at least 3.68
// ms.  TF32 on the tensor cores runs at 495 TFLOP/s but keeps 10 mantissa
// bits; 3xTF32 splits each word v into hi and lo and sums lo*hi + hi*lo +
// hi*hi (lo*lo, about 2^-20 of a product, is dropped): close to f32
// accuracy at a third of the TF32 rate, a bound of 1.49 ms for the same
// work.
//
// What the design does about it (csrc/conv_lb_sm90.cu's implicit GEMM,
// with csrc/matmul_lb_sm90_tf32.cu's 3xTF32 machinery).
//  * Implicit GEMM: M = output pixels, N = Co, K = (Ci block, window).  A
//    CTA owns two 64-pixel blocks, each an 8 x 8 square of output pixels
//    of one image (side by side, or in two images: the wrapper's
//    `sm90_tf32_plan`), x BN output channels (32, 64 or 128).  A K step
//    is one window of one Ci block of 32 channels.
//  * A, the input, from registers.  TF32 wgmma reads shared memory
//    K-major only, and x is channel-contiguous per pixel; A may come from
//    registers in any order.  Per Ci block one 4-D TMA load over (Ci, W,
//    H, B) brings the (ty + (Hk-1)*dly) x (tx + (Wk-1)*dlx) halo of the
//    CTA's bb images, one 128-byte row of 32 channels per pixel with the
//    128-byte swizzle; padding and ragged edges arrive as TMA's
//    out-of-bounds zeros, so no padded copy of x is made.  Every window
//    of the Ci block reads that halo: window (ky, kx) is the same rows
//    shifted by (ky*dly*hx + kx*dlx) whole rows (the wrapper's win_off).
//    Thread t of warp v owns block pixels (2v, t/4) and (2v + 1, t/4)
//    (the accumulator's rows) and loads channels [8c, 8c + 8) of each (c
//    = t % 4), two 16-byte loads a pixel, conflict-free: a quarter warp
//    is two consecutive halo rows x 4 chunks, which the swizzle puts in 8
//    distinct 16-byte chunks.  k8 step kk takes word 2kk as fragment
//    column c and word 2kk + 1 as column c + 4: the K order inside a Ci
//    block is permuted, and B is written in the same order.
//  * The split is hi = v's top 19 bits (a TF32 value exactly, read
//    unchanged however the tensor cores read an operand's low 13 bits)
//    and lo = v - hi (exact in f32, read as TF32 in turn), two
//    instructions a word, in registers.
//  * B, the weights, rewritten by producer warps.  w is HWIO, so the (Ci
//    block, window) slice is N-major.  TMA brings it (a 3-D map over
//    (Co, wCi, Hk*Wk), boxes of 32 Co x 32 Ci, 128-byte swizzle; a Ci
//    block past wCi arrives as zeros and never reads the next window's
//    rows) into a ring of kWStages stages; three warps of the producer
//    warpgroup rewrite each slice once into K-major hi and lo tiles (each
//    output channel a 128-byte row of the 32 channels in the permuted
//    order, 128-byte swizzle) in a ring of kBStages stages, fence them to
//    the async proxy and signal the consumers.  wCi is Ci, or fewer: the
//    1x1 conv of an im2col plane (route sm90_im2col,
//    csrc/wgrad_im2col.cu) reads w (Hk, Wk, Ci, Co) as its Hk*Wk*Ci rows
//    against the plane's 32 channels.
//  * The products.  Each consumer warpgroup runs three wgmma m64nBNk8
//    .tf32 per k8 step into one accumulator: lo*hi, hi*lo, hi*hi.  A
//    fragments alternate between two buffers with one group left in
//    flight while the next step's are split.
//  * Promotion.  The tensor cores' f32 sums drift with the length they
//    sum, and K is Hk*Wk*Ci (4608 at VGG's conv5_x).  Every kPromote K
//    steps (32 of K each) the consumers wait for their wgmma, add the
//    accumulator into a second f32 accumulator on the CUDA cores (round
//    to nearest) and start the next range afresh (the first product's
//    scale-d 0).  The second accumulator is why BN stops at 128: ptxas
//    holds every thread of a 384-thread CTA to 168 registers.
//  * One order.  K is never split across CTAs, and each output word is
//    summed in the same order whatever tile holds it: the backward's
//    recompute (no epilogue) reproduces the forward's pre-epilogue sums
//    bit for bit, so its ReLU and pool choices are the forward's.
//  * The epilogue runs on the accumulator layout (thread t of warp v
//    holds block rows 2v, 2v + 1, column t/4, channels 8j + 2(t%4), +1):
//    bias, residual and ReLU in f32 registers; a 2x2 pool is a max over
//    the thread's two rows and one shuffle with the neighbouring column's
//    thread, so only pooled words are stored, with no rounding.
//  * lo_terms = 0 zeroes the lo words (1xTF32): a control that the small
//    terms are real, never a route.
//  * No persistence, no clusters, no TMA store yet.

#include <cuda.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;    // warpgroups, one 8 x 8 pixel block each
constexpr int kTransposers = 3;  // producer-warpgroup warps rewriting w
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBK = 32;          // channels of a Ci block: one 128-byte row
constexpr int kWStages = 4;      // weight ring: (Ci block, window) stages
constexpr int kBStages = 2;      // ring of the hi/lo B tiles
constexpr int kHStages = 2;      // halo ring: Ci blocks
constexpr int kMaxWin = 128;     // windows whose offsets a launch carries
// K steps the tensor cores sum before the consumers promote their sums
// into the CUDA cores' (0: never): the wrapper's TF32_PROMOTE
constexpr int kPromote = 2;

struct Geom {
  int B, Ho, Wo, Co;
  int py, px;            // the halo of output (oy, ox) starts at (oy-py, ox-px)
  int bb, ty, tx;        // CTA tile: bb images x ty x tx output pixels
  int nty, ntx;          // tiles along Ho and Wo
  int ncb;               // Ci blocks of 32 channels
  int nwin;              // Hk * Wk
  int h_stage;           // bytes of one halo stage (a 1024-byte multiple)
  int sbo;               // one halo row: hx * 128 bytes
  int halo_tx;           // bytes TMA writes into one halo stage
  int pool, relu;
  uint32_t lo_mask;      // 0xffffffff (3xTF32) or 0 (1xTF32 control)
  int blk_off[kConsumers];  // each consumer's block inside the halo
  int win_off[kMaxWin];     // window ky*Wk + kx -> byte shift in the halo
};

template <int BN>
struct Smem {
  static constexpr int kW = BN * kBK * 4;   // one weight slice as TMA brings it
  static constexpr int kBt = BN * kBK * 4;  // one hi or lo B tile
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

// one 3-D TMA box (a weight slice) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// one 4-D TMA box (the halo of a Ci block) into shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// make this thread's shared-memory accesses ordered with the async proxy
// (wgmma's reads, TMA's writes)
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
  if constexpr (BN == 32)
    wgmma_n32(d, a, db, acc);
  else if constexpr (BN == 64)
    wgmma_n64(d, a, db, acc);
  else
    wgmma_n128(d, a, db, acc);
}

// BN: output channels per CTA, a constant so that the steps unroll and
// the sums and A fragments stay in registers
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_lb_sm90_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const float* __restrict__ bias,
                         const float* __restrict__ res,
                         float* __restrict__ out,
                         const __grid_constant__ Geom g) {
  extern __shared__ uint8_t smem_raw[];
  using S = Smem<BN>;
  // from a 1024-byte line (the swizzle's period): the weight ring, the B
  // ring (per stage the hi tile, then the lo tile), the halo ring (each
  // stage a 1024-byte multiple), then a full and an empty mbarrier per
  // stage of each ring
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t w_ring = (raw + 1023) & ~1023u;
  const uint32_t b_ring = w_ring + kWStages * S::kW;
  const uint32_t h_ring = b_ring + kBStages * 2 * S::kBt;
  const uint32_t bars = h_ring + kHStages * g.h_stage;
  auto w_full = [&](int s) { return bars + 8 * s; };
  auto w_empty = [&](int s) { return bars + 8 * (kWStages + s); };
  auto b_full = [&](int s) { return bars + 8 * (2 * kWStages + s); };
  auto b_empty = [&](int s) {
    return bars + 8 * (2 * kWStages + kBStages + s);
  };
  auto h_full = [&](int s) {
    return bars + 8 * (2 * kWStages + 2 * kBStages + s);
  };
  auto h_empty = [&](int s) {
    return bars + 8 * (2 * kWStages + 2 * kBStages + kHStages + s);
  };

  int t = blockIdx.x;
  const int xt = t % g.ntx;
  t /= g.ntx;
  const int yt = t % g.nty;
  const int b0 = (t / g.nty) * g.bb;
  const int oy0 = yt * g.ty, ox0 = xt * g.tx;
  const int n0 = blockIdx.y * BN;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int nsteps = g.ncb * g.nwin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), kTransposers);
    }
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(b_full(s), kTransposers);
      mbar_init(b_empty(s), kConsumers * 4);
    }
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(h_full(s), 1);
      mbar_init(h_empty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int warp = threadIdx.x / 32;
    if (warp == 0) {
      // the producer: one thread keeps both TMA rings full, in step order
      // (a Ci block's halo, then its windows' weight slices); the first
      // pass finds every stage empty (the parity of the phase before the
      // first)
      if (lane != 0) return;
      int ws = 0, hs = 0;
      uint32_t wph = 0, hph = 0;
      for (int cb = 0; cb < g.ncb; ++cb) {
        mbar_wait(h_empty(hs), hph ^ 1);
        mbar_expect_tx(h_full(hs), g.halo_tx);
        tma_load4(h_ring + hs * g.h_stage, &map_x, h_full(hs), cb * kBK,
                  ox0 - g.px, oy0 - g.py, b0);
        if (++hs == kHStages) {
          hs = 0;
          hph ^= 1;
        }
        for (int w = 0; w < g.nwin; ++w) {
          mbar_wait(w_empty(ws), wph ^ 1);
          mbar_expect_tx(w_full(ws), S::kW);
          // BN/32 boxes of 32 output channels x 32 input channels
#pragma unroll
          for (int j = 0; j < BN / 32; ++j)
            tma_load3(w_ring + ws * S::kW + j * 32 * kBK * 4, &map_w,
                      w_full(ws), n0 + 32 * j, cb * kBK, w);
          if (++ws == kWStages) {
            ws = 0;
            wph ^= 1;
          }
        }
      }
      return;
    }
    // the transposers: per step, the weight slice -> hi and lo [n][32
    // words] (K-major), word q of 16-byte chunk r of a row holding input
    // channel r + 8q (the order the consumers' A fragments read).  A unit
    // is 32 columns (a lane an output channel) and half of the chunks (r =
    // 4hf .. 4hf + 3, channels 4hf + j + 8q): 16 words in, four 16-byte
    // stores each of hi and lo (8 lanes, 8 rows of an atom: no conflict)
    const int tw = warp - 1;
    int ws = 0, bs = 0;
    uint32_t wph = 0, bph = 0;
    for (int step = 0; step < nsteps; ++step) {
      mbar_wait(w_full(ws), wph);
      mbar_wait(b_empty(bs), bph ^ 1);
      const uint32_t src = w_ring + ws * S::kW;
      const uint32_t dst = b_ring + bs * 2 * S::kBt;
      for (int u = tw; u < (BN / 32) * 2; u += kTransposers) {
        const int nb = u / 2, hf = u % 2;
        const int n = nb * 32 + lane;
        float v[4][4];   // v[j][q]: input channel 4hf + j + 8q of column n
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j][q] = lds(swz(src + nb * 32 * kBK * 4 +
                              (4 * hf + j + 8 * q) * 128 + lane * 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_tf32(v[j][q], g.lo_mask, hi[q], lo[q]);
          const uint32_t d = dst + n * 128 + (((4 * hf + j) ^ (n % 8)) << 4);
          sts4(d, hi);
          sts4(d + S::kBt, lo);
        }
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(w_empty(ws));
        mbar_arrive(b_full(bs));
      }
      if (++ws == kWStages) {
        ws = 0;
        wph ^= 1;
      }
      if (++bs == kBStages) {
        bs = 0;
        bph ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int cw = wg - 1;   // this consumer's block of the CTA tile
  const int v4 = (threadIdx.x % 128) / 32;
  // this thread's pixels (2v, t/4) and (2v + 1, t/4) of its block: halo
  // rows 2v*hx + t/4 and one halo row (sbo) on, channels [8c, 8c + 8)
  const int cq = lane % 4;
  const uint32_t a_off = g.blk_off[cw] +
                         (2 * v4 * (g.sbo / 128) + lane / 4) * 128 + cq * 32;
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
  int w = 0, hs = 0, bs = 0, prev_bs = 0, since = 0;
  uint32_t hph = 0, bph = 0, h_base = 0;
  int keep = 0;   // 0: the next product starts a range afresh
  for (int step = 0; step < nsteps; ++step) {
    if (w == 0) {
      mbar_wait(h_full(hs), hph);
      h_base = h_ring + hs * g.h_stage;
    }
    mbar_wait(b_full(bs), bph);
    const uint32_t at = h_base + a_off + g.win_off[w];
    const uint32_t bt = b_ring + bs * 2 * S::kBt;
    const bool last = w == g.nwin - 1;
    float4 x[2];   // pixels p0, p1: channels 8c + 4h .. + 3 of half h
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const int h = kk / 2, f = kk % 2;
      if (f == 0) {
        x[0] = lds4(swz(at + h * 16));
        x[1] = lds4(swz(at + g.sbo + h * 16));
        if (h == 1 && last) {
          // every A word of this Ci block is loaded: its halo is free.
          // The loads' values are not used yet, so nothing has waited for
          // them: the proxy fence keeps the next TMA write into the stage
          // (the async proxy) behind them
          fence_async_shared();
          __syncwarp();
          if (lane == 0) mbar_arrive(h_empty(hs));
        }
      }
      // a0 (pixel p0, column c), a1 (p1, c), a2 (p0, c + 4), a3 (p1, c +
      // 4): channels 8c + 2kk and 8c + 2kk + 1 of the thread's eight
      split_tf32(word(x[0], 2 * f), g.lo_mask, af[f][0], af[f][4]);
      split_tf32(word(x[1], 2 * f), g.lo_mask, af[f][1], af[f][5]);
      split_tf32(word(x[0], 2 * f + 1), g.lo_mask, af[f][2], af[f][6]);
      split_tf32(word(x[1], 2 * f + 1), g.lo_mask, af[f][3], af[f][7]);
      const uint64_t dhi = gmma_desc(bt + kk * 32);
      const uint64_t dlo = gmma_desc(bt + S::kBt + kk * 32);
      wgmma_fence();
      wgmma_tile<BN>(acc, &af[f][4], dhi, keep);   // lo * hi
      wgmma_tile<BN>(acc, &af[f][0], dlo, 1);      // hi * lo
      wgmma_tile<BN>(acc, &af[f][0], dhi, 1);      // hi * hi
      wgmma_commit();
      keep = 1;
      // this step alone in flight: the other buffer's fragments may be
      // overwritten; at a K step's first k8 step the last of the step
      // before has retired, and its B tiles are free
      wgmma_wait<1>();
      fence_regs<8>(af[f ^ 1]);
      if (kk == 0 && step > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(b_empty(prev_bs));
      }
    }
    prev_bs = bs;
    if (++bs == kBStages) {
      bs = 0;
      bph ^= 1;
    }
    if (last) {
      w = 0;
      if (++hs == kHStages) {
        hs = 0;
        hph ^= 1;
      }
    } else {
      ++w;
    }
    if (kPromote > 0 && ++since == kPromote && step + 1 < nsteps) {
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

  // thread t of warp v holds block rows 2v (acc 4j, 4j+1) and 2v + 1
  // (4j+2, 4j+3), block column t/4, channels 8j + 2(t%4), +1
  const int b = b0 + cw * (g.bb - 1);
  const int oy = oy0 + 2 * v4;
  const int ox = ox0 + cw * (g.tx - 8) + lane / 4;
  const bool img = b < g.B;
  const bool ok0 = img && oy < g.Ho && ox < g.Wo;
  const bool ok1 = img && oy + 1 < g.Ho && ox < g.Wo;
  const size_t px0 = (static_cast<size_t>(b) * g.Ho + oy) * g.Wo + ox;
  const size_t px1 = px0 + g.Wo;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    // Co % 4 == 0 and co even: the pair is in range or not as one
    const int co = n0 + 8 * j + 2 * (lane % 4);
    const bool in_co = co < g.Co;
    float v[4] = {sum[4 * j] + acc[4 * j], sum[4 * j + 1] + acc[4 * j + 1],
                  sum[4 * j + 2] + acc[4 * j + 2],
                  sum[4 * j + 3] + acc[4 * j + 3]};
    if (bias != nullptr && in_co) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + co);
      v[0] += bv.x;
      v[1] += bv.y;
      v[2] += bv.x;
      v[3] += bv.y;
    }
    if (res != nullptr && in_co) {
      if (ok0) {
        const float2 r = *reinterpret_cast<const float2*>(res + px0 * g.Co + co);
        v[0] += r.x;
        v[1] += r.y;
      }
      if (ok1) {
        const float2 r = *reinterpret_cast<const float2*>(res + px1 * g.Co + co);
        v[2] += r.x;
        v[3] += r.y;
      }
    }
    if (g.relu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
    }
    if (g.pool == 1) {
      if (in_co && ok0)
        *reinterpret_cast<float2*>(out + px0 * g.Co + co) =
            make_float2(v[0], v[1]);
      if (in_co && ok1)
        *reinterpret_cast<float2*>(out + px1 * g.Co + co) =
            make_float2(v[2], v[3]);
    } else {
      // 2x2: rows 2v and 2v + 1 here, columns t/4 and t/4 ^ 1 in the
      // thread 4 lanes away; pooled (oy/2, ox/2) from even columns
      float m0 = fmaxf(v[0], v[2]);
      float m1 = fmaxf(v[1], v[3]);
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
      if (in_co && ok0 && (lane / 4) % 2 == 0) {
        const int hp = g.Ho / 2, wp = g.Wo / 2;
        const size_t q = (static_cast<size_t>(b) * hp + oy / 2) * wp + ox / 2;
        *reinterpret_cast<float2*>(out + q * g.Co + co) = make_float2(m0, m1);
      }
    }
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

// an f32 map of `rank` dimensions (innermost first), strides in bytes of
// dimensions 1.., boxes of `box`, 128-byte swizzle, zero fill out of bounds
int make_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int BN>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw,
                   const void* bias, const void* res, void* out,
                   const Geom& g, int smem_bytes, cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if (smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_lb_sm90_tf32_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = smem_bytes;
  }
  const long long tiles = static_cast<long long>((g.B + g.bb - 1) / g.bb) *
                          g.nty * g.ntx;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), (g.Co + BN - 1) / BN);
  conv_lb_sm90_tf32_kernel<BN><<<grid, kThreads, smem_bytes, stream>>>(
      mx, mw, static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<float*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Ci), w (Hk, Wk, wCi, Co) with 1 <= wCi <= Ci (channels
// wCi .. Ci - 1 of x meet zero weights), bias (Co) or null, res (B, Ho,
// Wo, Co) or null, out (B, Ho/pool, Wo/pool, Co): contiguous f32, bases
// 16-byte aligned, Ci and Co multiples of 4, stride 1 (the wrapper's
// route checks all of it).  The tile (bb, ty, tx, bn), the halo box (hy,
// hx) and every shared-memory offset come from the wrapper's
// sm90_tf32_plan: h_stage (one halo stage), blk_off0/1 (the consumers'
// blocks) and win_off (Hk*Wk window shifts, host memory).  lo_terms = 0
// drops the lo words (1xTF32, a control).  Returns a CUDA error code, or
// 1000 + the CUresult of a refused tensor map, or -1 if the driver has no
// cuTensorMapEncodeTiled.
extern "C" int conv_lb_sm90_tf32_forward(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, const void* win_off, int B, int H, int W, int Ci, int wCi,
    int Co, int Hk, int Wk, int Ho, int Wo, int py, int px, int pool, int relu,
    int bb, int ty, int tx, int hy, int hx, int bn, int h_stage, int blk_off0,
    int blk_off1, int smem_bytes, int lo_terms, void* stream) {
  const int nwin = Hk * Wk;
  if (B < 1 || Ci < 1 || wCi < 1 || wCi > Ci || Co < 1 || Ci % 4 ||
      Co % 4 || nwin < 1 || nwin > kMaxWin || (pool != 1 && pool != 2) ||
      ty != 8 || bb * tx != 16 || hy > 256 || hx > 256 ||
      h_stage % 1024 != 0 || h_stage < bb * hy * hx * 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.B = B; g.Ho = Ho; g.Wo = Wo; g.Co = Co;
  g.py = py; g.px = px;
  g.bb = bb; g.ty = ty; g.tx = tx;
  g.nty = (Ho + ty - 1) / ty;
  g.ntx = (Wo + tx - 1) / tx;
  g.ncb = (Ci + kBK - 1) / kBK;
  g.nwin = nwin;
  g.h_stage = h_stage;
  g.sbo = hx * 128;
  g.halo_tx = bb * hy * hx * 128;
  g.pool = pool; g.relu = relu;
  g.lo_mask = lo_terms ? 0xffffffffu : 0u;
  g.blk_off[0] = blk_off0;
  g.blk_off[1] = blk_off1;
  const int* offs = static_cast<const int*>(win_off);
  for (int i = 0; i < kMaxWin; ++i) g.win_off[i] = i < nwin ? offs[i] : 0;

  // x: (Ci, W, H, B), the halo of one Ci block per box
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Ci),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {4ull * Ci, 4ull * Ci * W, 4ull * Ci * W * H};
  const cuuint32_t x_box[4] = {kBK, static_cast<cuuint32_t>(hx),
                               static_cast<cuuint32_t>(hy),
                               static_cast<cuuint32_t>(bb)};
  // w: (Co, wCi, Hk*Wk), 32 output channels x 32 input channels per box
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(Co),
                                static_cast<cuuint64_t>(wCi),
                                static_cast<cuuint64_t>(nwin)};
  const cuuint64_t w_strides[2] = {4ull * Co, 4ull * Co * wCi};
  const cuuint32_t w_box[3] = {32, kBK, 1};
  CUtensorMap mx, mw;
  int err = make_map(&mx, x, 4, x_dims, x_strides, x_box);
  if (err) return err;
  err = make_map(&mw, w, 3, w_dims, w_strides, w_box);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bn == 32)
    e = launch<32>(mx, mw, bias, res, out, g, smem_bytes, s);
  else if (bn == 64)
    e = launch<64>(mx, mw, bias, res, out, g, smem_bytes, s);
  else if (bn == 128)
    e = launch<128>(mx, mw, bias, res, out, g, smem_bytes, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* conv_lb_sm90_tf32_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
