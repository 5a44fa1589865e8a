// Batch-folded NHWC convolution in f32 on Hopper's tensor cores (sm_90a)
// in 3xTF32, at any stride, with the fused bias -> residual -> ReLU -> 2x2
// max-pool epilogue, and the data gradient of a strided conv by output
// phases: f32 in, f32 sums, f32 out.
//
// Replaces, with csrc/conv_lb_sm90.cu (bf16) and csrc/conv_lb.cu (which
// keeps bf16 at strides, lhs dilation and the layouts TMA cannot
// describe), the TPU kernel `_conv_kernel` launched by `conv_lb_call`
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
// work.  ResNet-20/32's strided convs at batch 8 are bounded under 1 us
// each: there the host's time to enqueue a launch is the cost, and the
// launch entry below is built for it.
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
//    registers in any order.  Per Ci block 4-D TMA loads over (Ci, W, H,
//    B) bring the halo of the CTA's bb images, one 128-byte row of 32
//    channels per pixel with the 128-byte swizzle; padding and ragged
//    edges arrive as TMA's out-of-bounds zeros, so no padded copy of x is
//    made.  Every window of the Ci block reads that halo at its own shift
//    (the wrapper's win_off).
//  * Strides: the halo as parts.  At stride (sy, sx) output pixel (oy,
//    ox) of window (ky, kx) reads x at (sy*oy + ky*dly - py, sx*ox +
//    kx*dlx - px).  The halo is loaded as one box per residue (ry, rx) =
//    (ky*dly mod sy, kx*dlx mod sx) that some window has (a part: 4 at a
//    3x3/2, 1 at a 1x1/2), each with a TMA traversal stride of (sy, sx)
//    (cuTensorMapEncodeTiled's elementStrides), so that a part holds the
//    strided pixels densely: ty + ((Hk-1)*dly)/sy rows of tx +
//    ((Wk-1)*dlx)/sx.  Window (ky, kx) reads its part at the shift
//    (ky*dly/sy, kx*dlx/sx): consecutive output pixels read consecutive
//    halo rows, as at stride 1, and the loads stay conflict-free (one
//    dense box read at steps of s pixels would put a quarter warp's two
//    rows on one swizzle parity: 2-way conflicts).  At stride 1 there is
//    one part and the layout is the stride-1 kernel's.
//  * Thread t of warp v owns block pixels (2v, t/4) and (2v + 1, t/4)
//    (the accumulator's rows) and loads channels [8c, 8c + 8) of each (c
//    = t % 4), two 16-byte loads a pixel, conflict-free: a quarter warp
//    is two consecutive halo rows x 4 chunks, which the swizzle puts in 8
//    distinct 16-byte chunks.  k8 step kk takes word 2kk as fragment
//    column c and word 2kk + 1 as column c + 4: the K order inside a Ci
//    block is permuted, and B is written in the same order.
//  * The data gradient of a strided conv, by phases (wt = 1).  dx of the
//    conv x -> gy at stride s is, for dx pixels = (qy, qx) mod s (a
//    phase, one grid z index of the launch), a stride-1 conv of the
//    compact gy over the taps that land on real samples: tap ky with (qy
//    + py - ky*dly) = ey*s reads gy row my + ey for dx row s*my + qy.
//    Each phase carries its own windows (win0, nwin), halo origin (y0,
//    x0) and store offset (qy, qx); stores go out at stride (osy, osx).
//    The lhs-dilated zeros are never multiplied, gy is not padded (the
//    rows past it are TMA's zeros), dx is written at its own size, and w
//    is read as it is: window i takes weight tap win_w[i] (no flipped
//    copy), and its (Ci, Co) slice transposed by the transposers.  A
//    phase with no tap writes zeros.
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
//    against the plane's 32 channels.  For a data gradient the same map
//    over w's (Co, Ci, Hk*Wk) brings boxes whose rows are output channels
//    (N) of 32 input channels (K): K-major already, so the transposers
//    read each row's 16-byte chunks (conflict-free) and only permute and
//    split them.
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
//  * One lean launch.  The wrapper packs every integer of a plan once per
//    geometry into `Args` and fills in only the pointers and the stream
//    per call; the entry takes it by pointer.  Tensor maps are pure
//    functions of their base, extents, strides and box, so the entry
//    keeps the last kMapCache of them and encodes a map only for a key it
//    has not seen (a layer's w is the same from call to call).
//  * No persistence, no clusters, no TMA store yet.

#include <cuda.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConsumers = 2;    // warpgroups, one 8 x 8 pixel block each
constexpr int kTransposers = 3;  // producer-warpgroup warps rewriting w
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBK = 32;          // channels of a Ci block: one 128-byte row
constexpr int kWStages = 4;      // weight ring: (Ci block, window) stages
constexpr int kBStages = 2;      // ring of the hi/lo B tiles
constexpr int kHStages = 2;      // halo ring: Ci blocks
constexpr int kMaxWin = 128;     // windows whose offsets a launch carries
constexpr int kMaxPart = 16;     // halo boxes of a Ci block (sy * sx residues)
constexpr int kMaxPhase = 16;    // output phases of one launch
constexpr int kMapCache = 32;    // tensor maps the entry keeps
// K steps the tensor cores sum before the consumers promote their sums
// into the CUDA cores' (0: never): the wrapper's TF32_PROMOTE
constexpr int kPromote = 2;

// one output phase: its plane, tiles, halo origin, stores and windows
struct Phase {
  int ho, wo;            // the phase's output plane (its tiles cover it)
  int nty, ntx;          // tiles along ho and wo
  int y0, x0;            // tile (oy0, ox0)'s halo box p starts at (sy*oy0
                         // + y0 + part_y[p], sx*ox0 + x0 + part_x[p])
  int qy, qx;            // pixel (my, mx) is stored at (osy*my + qy, osx*mx + qx)
  int win0, nwin;        // its windows: win_off / win_w [win0, win0 + nwin)
};

// what the kernel reads of a launch (the wrapper's `Tf32ConvGeom`)
struct Geom {
  int B, OH, OW, Co;     // out (B, OH/pool, OW/pool, Co)
  int bb, ty, tx;        // CTA tile: bb images x ty x tx output pixels
  int ncb;               // Ci blocks of 32 channels
  int sy, sx;            // halo rows and columns a tile row or column moves
  int nparts;            // halo boxes of a Ci block
  int part_bytes;        // one box (a 1024-byte multiple)
  int h_stage;           // bytes of one halo stage (a 1024-byte multiple)
  int halo_tx;           // bytes TMA writes into one halo stage
  int row_step;          // bytes between output rows in the halo (a box row)
  int osy, osx;          // output stride of a phase's pixels
  int pool, relu;
  int wt;                // 1: a data gradient by phases, w's (Ci, Co) slices
                         // read transposed (the launch's DGRAD)
  uint32_t lo_mask;      // 0xffffffff (3xTF32) or 0 (1xTF32 control)
  int blk_off[kConsumers];  // each consumer's block inside the halo
  int part_y[kMaxPart];     // each box's residue row and column
  int part_x[kMaxPart];
  Phase ph[kMaxPhase];
  int win_off[kMaxWin];     // window -> byte shift in the halo
  int win_w[kMaxWin];       // window -> weight tap ky * Wk + kx
};

// one launch as the wrapper packs it (`Tf32ConvArgs`): the pointers and
// the stream per call, the rest once per geometry
struct Args {
  const void* x;
  const void* w;
  const void* bias;      // or null
  const void* res;       // or null
  void* out;
  void* stream;
  int H, W, Ci;          // x (B, H, W, Ci)
  int wd0, wd1, wd2;     // w's map: its last extent, the one before, Hk*Wk
  int box_y, box_x;      // the x box in the tensor (traversal stride included)
  int es_y, es_x;        // the x map's traversal strides
  int bn, nphase, tiles, smem_bytes;
  Geom g;
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
// the sums and A fragments stay in registers.  DGRAD: a data gradient by
// phases (the phase a grid z index, w's slices read transposed); a
// forward reads phase 0 at constant offsets, so that no register holds a
// phase's fields (at BN 128 the consumers have none to spare)
template <int BN, bool DGRAD>
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

  // this CTA's phase and tile; a tile past the phase's plane (phases
  // differ by a row or column) has no work
  const Phase& ph = g.ph[DGRAD ? blockIdx.z : 0];
  int t = blockIdx.x;
  const int xt = t % ph.ntx;
  t /= ph.ntx;
  const int yt = t % ph.nty;
  const int b0 = (t / ph.nty) * g.bb;
  if (b0 >= g.B) return;
  const int oy0 = yt * g.ty, ox0 = xt * g.tx;
  const int n0 = blockIdx.y * BN;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int nsteps = g.ncb * ph.nwin;

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
      // (a phase with no window loads nothing)
      if (lane != 0 || nsteps == 0) return;
      int ws = 0, hs = 0;
      uint32_t wph = 0, hph = 0;
      const int hy0 = g.sy * oy0 + ph.y0, hx0 = g.sx * ox0 + ph.x0;
      for (int cb = 0; cb < g.ncb; ++cb) {
        mbar_wait(h_empty(hs), hph ^ 1);
        mbar_expect_tx(h_full(hs), g.halo_tx);
        for (int p = 0; p < g.nparts; ++p)
          tma_load4(h_ring + hs * g.h_stage + p * g.part_bytes, &map_x,
                    h_full(hs), cb * kBK, hx0 + g.part_x[p],
                    hy0 + g.part_y[p], b0);
        if (++hs == kHStages) {
          hs = 0;
          hph ^= 1;
        }
        for (int w = 0; w < ph.nwin; ++w) {
          mbar_wait(w_empty(ws), wph ^ 1);
          mbar_expect_tx(w_full(ws), S::kW);
          // BN/32 boxes of 32 output channels x 32 input channels (rows
          // input channels; for a data gradient rows output channels)
          const int tap = DGRAD ? g.win_w[ph.win0 + w] : w;
#pragma unroll
          for (int j = 0; j < BN / 32; ++j)
            tma_load3(w_ring + ws * S::kW + j * 32 * kBK * 4, &map_w,
                      w_full(ws), DGRAD ? cb * kBK : n0 + 32 * j,
                      DGRAD ? n0 + 32 * j : cb * kBK, tap);
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
        if (DGRAD) {
          // rows are columns n: chunk 2q + hf of row n holds channels
          // 8q + 4hf .. + 3 (8 lanes, 8 rows of an atom: no conflict)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 c =
                lds4(swz(src + nb * 32 * kBK * 4 + lane * 128 +
                         (2 * q + hf) * 16));
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j][q] = word(c, j);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j][q] = lds(swz(src + nb * 32 * kBK * 4 +
                                (4 * hf + j + 8 * q) * 128 + lane * 4));
        }
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
  // rows 2v*hx + t/4 and one box row (row_step) on, channels [8c, 8c + 8)
  const int cq = lane % 4;
  const uint32_t a_off = g.blk_off[cw] + 2 * v4 * g.row_step +
                         (lane / 4) * 128 + cq * 32;
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
    const uint32_t at = h_base + a_off + g.win_off[DGRAD ? ph.win0 + w : w];
    const uint32_t bt = b_ring + bs * 2 * S::kBt;
    const bool last = w == ph.nwin - 1;
    float4 x[2];   // pixels p0, p1: channels 8c + 4h .. + 3 of half h
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const int h = kk / 2, f = kk % 2;
      if (f == 0) {
        x[0] = lds4(swz(at + h * 16));
        x[1] = lds4(swz(at + g.row_step + h * 16));
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
  // (my, mx) in the phase's plane, stored at (oy, ox) = (osy*my + qy,
  // osx*mx + qx)
  const int b = b0 + cw * (g.bb - 1);
  const int my = oy0 + 2 * v4;
  const int mx = ox0 + cw * (g.tx - 8) + lane / 4;
  const bool img = b < g.B;
  const bool ok0 = img && my < ph.ho && mx < ph.wo;
  const bool ok1 = img && my + 1 < ph.ho && mx < ph.wo;
  const int oy = DGRAD ? g.osy * my + ph.qy : my;
  const int ox = DGRAD ? g.osx * mx + ph.qx : mx;
  const size_t px0 = (static_cast<size_t>(b) * g.OH + oy) * g.OW + ox;
  const size_t px1 = px0 + static_cast<size_t>(DGRAD ? g.osy : 1) * g.OW;
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
        const int hp = g.OH / 2, wp = g.OW / 2;
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

// an f32 map: `rank` dimensions (innermost first), strides in bytes of
// dimensions 1.., boxes of `box` traversed at `elem` (the box holds
// box[i] / elem[i] elements along i), 128-byte swizzle, zero fill out of
// bounds.  A map is a pure function of these, so the last kMapCache of
// them are kept and a key seen before is not encoded again
struct MapKey {
  const void* base;
  int rank;
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  cuuint32_t box[4];
  cuuint32_t elem[4];
};

struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};

int cached_map(CUtensorMap* map, const MapKey& key) {
  static MapSlot slots[kMapCache];
  static int next = 0;
  for (int i = 0; i < kMapCache; ++i)
    if (slots[i].used && memcmp(&slots[i].key, &key, sizeof key) == 0) {
      *map = slots[i].map;
      return 0;
    }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, key.rank,
      const_cast<void*>(key.base), key.dims, key.strides, key.box, key.elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  MapSlot& slot = slots[next];
  next = (next + 1) % kMapCache;
  slot.key = key;
  slot.map = *map;
  slot.used = true;
  return 0;
}

template <int BN, bool DGRAD>
cudaError_t launch_kernel(const CUtensorMap& mx, const CUtensorMap& mw,
                          const Args& a) {
  static int opted_in = 48 * 1024;
  if (a.smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_lb_sm90_tf32_kernel<BN, DGRAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = a.smem_bytes;
  }
  const dim3 grid(a.tiles, (a.g.Co + BN - 1) / BN, a.nphase);
  conv_lb_sm90_tf32_kernel<BN, DGRAD>
      <<<grid, kThreads, a.smem_bytes, static_cast<cudaStream_t>(a.stream)>>>(
          mx, mw, static_cast<const float*>(a.bias),
          static_cast<const float*>(a.res), static_cast<float*>(a.out), a.g);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw,
                   const Args& a) {
  return a.g.wt ? launch_kernel<BN, true>(mx, mw, a)
                : launch_kernel<BN, false>(mx, mw, a);
}

}  // namespace

// One launch from `a` (the wrapper's `Tf32ConvArgs`): x (B, H, W, Ci), w
// (Hk, Wk, wd1, wd0) (a forward: wd1 = wCi <= Ci input channels, channels
// wCi .. Ci - 1 of x meeting zero weights, wd0 = Co; a data gradient, wt
// = 1: the forward's w, wd1 its input channels = Co here, wd0 its output
// channels <= Ci), bias (Co) or null, res (B, OH, OW, Co) or null, out
// (B, OH/pool, OW/pool, Co): contiguous f32, bases 16-byte aligned, Ci
// and Co multiples of 4 (the wrapper's route checks all of it).  The
// tile, the halo's parts and steps, the phases and every window's shift
// and weight tap come from the wrapper's plan.  Returns a CUDA error
// code, or 1000 + the CUresult of a refused tensor map, or -1 if the
// driver has no cuTensorMapEncodeTiled.
// (`args` is an `Args`, whose type is this file's own: the entry takes it
// as a plain pointer so that its name is exported)
extern "C" int conv_lb_sm90_tf32_launch(const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  const Geom& g = a.g;
  bool ok = g.B >= 1 && a.Ci >= 1 && g.Co >= 1 && a.Ci % 4 == 0 &&
            g.Co % 4 == 0 && a.wd0 % 4 == 0 && (g.pool == 1 || g.pool == 2) &&
            g.ty == 8 && g.bb * g.tx == 16 && a.box_y <= 256 &&
            a.box_x <= 256 && a.es_y >= 1 && a.es_y <= 8 && a.es_x >= 1 &&
            a.es_x <= 8 && g.nparts >= 1 && g.nparts <= kMaxPart &&
            g.part_bytes % 1024 == 0 && g.h_stage % 1024 == 0 &&
            g.nparts * g.part_bytes <= g.h_stage && a.nphase >= 1 &&
            a.nphase <= kMaxPhase && a.tiles >= 1 &&
            (g.wt || a.nphase == 1) &&
            (g.pool == 1 || (!g.wt && g.osy == 1 && g.osx == 1));
  for (int i = 0; ok && i < a.nphase; ++i)
    ok = g.ph[i].nwin >= 0 && g.ph[i].win0 >= 0 &&
         g.ph[i].win0 + g.ph[i].nwin <= kMaxWin;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  // x: (Ci, W, H, B), one halo box of one Ci block per load
  MapKey kx;
  memset(&kx, 0, sizeof kx);
  kx.base = a.x;
  kx.rank = 4;
  kx.dims[0] = a.Ci;
  kx.dims[1] = a.W;
  kx.dims[2] = a.H;
  kx.dims[3] = g.B;
  kx.strides[0] = 4ull * a.Ci;
  kx.strides[1] = 4ull * a.Ci * a.W;
  kx.strides[2] = 4ull * a.Ci * a.W * a.H;
  kx.box[0] = kBK;
  kx.box[1] = a.box_x;
  kx.box[2] = a.box_y;
  kx.box[3] = g.bb;
  kx.elem[0] = 1;
  kx.elem[1] = a.es_x;
  kx.elem[2] = a.es_y;
  kx.elem[3] = 1;
  // w: (wd0, wd1, Hk*Wk), boxes of 32 x 32 of one tap
  MapKey kw;
  memset(&kw, 0, sizeof kw);
  kw.base = a.w;
  kw.rank = 3;
  kw.dims[0] = a.wd0;
  kw.dims[1] = a.wd1;
  kw.dims[2] = a.wd2;
  kw.strides[0] = 4ull * a.wd0;
  kw.strides[1] = 4ull * a.wd0 * a.wd1;
  kw.box[0] = 32;
  kw.box[1] = kBK;
  kw.box[2] = 1;
  kw.elem[0] = kw.elem[1] = kw.elem[2] = 1;
  CUtensorMap mx, mw;
  int err = cached_map(&mx, kx);
  if (err) return err;
  err = cached_map(&mw, kw);
  if (err) return err;
  cudaError_t e;
  if (a.bn == 32)
    e = launch<32>(mx, mw, a);
  else if (a.bn == 64)
    e = launch<64>(mx, mw, a);
  else if (a.bn == 128)
    e = launch<128>(mx, mw, a);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* conv_lb_sm90_tf32_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
