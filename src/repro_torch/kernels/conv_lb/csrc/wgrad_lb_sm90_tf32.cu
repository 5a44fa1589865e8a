// Weight gradient of an NHWC convolution in f32 on Hopper's tensor
// cores (sm_90a), at any stride, in 3xTF32:
//
//   dW[ky, kx, ci, co] = sum_{b, oy, ox}
//       x[b, sy*oy + ky*dly - py, sx*ox + kx*dlx - px, ci] * dy[b, oy, ox, co]
//
// (x read as zero outside the plane.)  f32 x and dy, f32 sums, f32 dW.
//
// Replaces, with csrc/wgrad_lb_sm90.cu (bf16) and csrc/wgrad_lb.cu (which
// keeps bf16 at strides and the layouts TMA cannot describe), the TPU kernel
// `_wgrad_kernel` launched by `wgrad_lb_call`
// (src/repro/kernels/conv_lb/wgrad.py:50, :94).  It computes the same
// function; it is not a block-by-block copy of it.
//
// The product.  dW is a (Hk*Wk*Ci) x Co matrix, the GEMM of M = Hk*Wk*Ci
// rows (window, ci), N = Co columns, over K = B*Ho*Wo output pixels.
//
// What bounds it on this card.  VGG's 3x3 layers after conv1_2 do
// 2*9*Ci*Co operations per reduction pixel against (Ci + Co) * 4 bytes:
// hundreds of operations per byte.  On FMA (67 TFLOP/s) the operations
// bound them.  TF32 on the tensor cores runs at 495 TFLOP/s but keeps
// 10 mantissa bits, which is not an f32 result; 3xTF32 splits each word
// v into hi = tf32(v) and lo = tf32(v - hi) and sums lo*hi + hi*lo +
// hi*hi (lo*lo, about 2^-20 of the product, is dropped): close to f32
// accuracy at a third of the TF32 rate, 165 TFLOP/s of f32 work, 2.5x
// the FMA rate.
//
// What the design does about it (csrc/wgrad_lb_sm90.cu's shape, turned
// round where TF32 forces it).
//  * TF32 wgmma reads shared-memory operands K-major only (imm-trans is
//    for 16-bit types), and here both x and dy are channel-contiguous,
//    i.e. MN-major.  A, however, may come from registers in any layout.
//  * A, the input, from registers.  Per 8 x 8 block of output pixels and
//    32-channel slice one 4-D TMA load over (Ci, W, H, B) brings the
//    (8 + (Hk-1)*dly) x (8 + (Wk-1)*dlx) halo, one 128-byte row per
//    pixel with the 128-byte swizzle, padding and ragged edges as TMA's
//    out-of-bounds zeros (no padded copy of x).  The consumers ld.shared
//    their m64k8 A fragments straight from it at each window's shift
//    (WndR: one halo serves every window), split each word v in
//    registers and feed both parts to wgmma.  A K step of 8 is one
//    output row of the block; fragment column t holds pixel 2t and
//    column t + 4 pixel 2t + 1 (the B tile is written in the same
//    order).  A thread's two fragment rows (r, r + 8) are two adjacent
//    channels (the wrapper's row order, undone on store), so its four
//    words are two 8-byte loads.  Bank pattern: a half-warp's 8-byte
//    load is 8 channels x 4 pixels of one parity; the swizzle XORs the
//    16-byte chunk with the pixel's row in its 1024-byte atom, and 4
//    pixels of one parity cover all 4 rows of that parity, so the 16
//    lanes fill 8 distinct chunks, 32 distinct banks: every fragment
//    load is two wavefronts, the least 256 bytes take.
//  * The split is hi = trunc(v), v's top 19 bits masked, and lo = v - hi:
//    hi is a TF32 value exactly, so the split is exact by construction
//    however the tensor cores read the low 13 bits of an operand, and
//    lo, exact in f32, is read as TF32 in turn (its error under 2^-20 of
//    v).  Two instructions a word (the mask and the subtraction), where
//    cvt.rna.tf32.f32 twice took five: a bring-up build that converted
//    with cvt spent as long on loads and conversions as on wgmma, and
//    the two did not overlap.
//  * B, the incoming gradient, rewritten once per pixel block.  TMA
//    brings the dy tile N-major (boxes of 32 channels x 8 x 8 pixels,
//    128-byte swizzled); three warps of the producer warpgroup rewrite
//    it into K-major hi and lo TF32 tiles (each output channel a
//    128-byte row of 32 pixels, 128-byte swizzle) in a ring of their
//    own, fence them to the async proxy and signal the consumers.
//    Every row block and window of the CTA then reads those tiles; the
//    rewrite is paid once per block, not once per window.
//  * Three wgmma m64nBNk8 .tf32 per row block and k8 step, lo*hi,
//    hi*lo, hi*hi, into the same f32 sums.  The dW tile stays in
//    registers over the CTA's pixel range (OutR): two consumer
//    warpgroups each hold NWC row blocks of 64 rows x BN columns.  A
//    fragments rotate through four buffers (8 registers a row block a
//    step) with two groups of wgmma left in flight, so a step's loads
//    and splits run while the tensor cores work on the two before; the
//    tile is at most 64 sums a thread.
//  * Strides: the halo as parts (csrc/conv_lb_sm90_tf32.cu's design).
//    Reduction pixel (oy, ox) of window (ky, kx) reads x at (sy*oy +
//    ky*dly - py, sx*ox + kx*dlx - px).  Per pixel block the halo is one
//    box per residue (ky*dly mod sy, kx*dlx mod sx) that some window has,
//    loaded at the TMA traversal stride (sy, sx), so each box holds its
//    strided pixels densely (8 + (Hk-1)*dly/sy rows of 8 + (Wk-1)*dlx/sx)
//    and window (ky, kx) reads its box at the shift (ky*dly/sy,
//    kx*dlx/sx): consecutive pixels of a row in consecutive halo rows, as
//    at stride 1, so the bank pattern above holds.  dy is compact: B and
//    its rewrite do not change.
//  * A row block is 64 rows of (window, channel): 64 channels of one
//    window, or 32 or 16 channels of 2 or 4 windows (cpr channels a
//    window) where Ci is small.  The wrapper passes every window's
//    shift in the halo.
//  * The split ranges are short (at most 64 pixel blocks, against the
//    bf16 kernel's 256): the tensor cores' f32 sums drift with a range's
//    length, and three products a k8 step add to them six times as
//    often as bf16's k16 steps.  A second pass sums the splits' slices
//    in split order (no atomics: two runs give the same bits).
//  * lo_terms = 0 zeroes the lo words (1xTF32): a control that the
//    small terms are real, never a route.
//  * One lean launch: the wrapper packs every integer of a plan once per
//    geometry into `Args` and fills in only the pointers and the stream
//    per call; the entry keeps the last kMapCache tensor maps and
//    encodes one only for a key it has not seen.
//  * No persistence, no clusters, no TMA store yet.

#include <cuda.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConsumers = 2;    // warpgroups, NWC row blocks each
constexpr int kTransposers = 3;  // producer-warpgroup warps rewriting dy
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlock = 8;        // a K step: kBlock x kBlock output pixels
constexpr int kBox = 32;         // channels of one 128-byte f32 box row
constexpr int kMaxWin = 128;     // windows whose offsets a launch carries
constexpr int kMaxStages = 8;    // TMA ring stages (dy tile + halo)
constexpr int kBStages = 2;      // ring stages of the hi/lo B tiles
constexpr int kMaxPart = 16;     // halo boxes of a slice (sy * sx residues)
constexpr int kMapCache = 32;    // tensor maps the entry keeps

// what the kernel reads of a launch (the wrapper's `Tf32WgradGeom`)
struct Geom {
  int Ci, Co, nwin;
  int py, px;            // box p of block (oy0, ox0) starts at (sy*oy0 - py
  int sy, sx;            // + part_y[p], sx*ox0 - px + part_x[p])
  int nby, nbx;          // pixel blocks along Ho, Wo
  int nblk;              // B * nby * nbx
  int bps;               // pixel blocks per split
  int cib;               // channels per Ci block (32, 64 or 128)
  int cpr;               // channels of one window in a row block (16, 32, 64)
  int nwg;               // window groups: ceil(nwin / (64 / cpr))
  int nrb;               // row blocks per Ci block: slices * nwg
  int ngrp;              // CTA row-block groups per Ci block
  int stages;            // TMA ring depth
  int sub_bytes;         // one 32-channel slice of the halo: nparts boxes
  int part_bytes;        // one box (a 1024-byte multiple)
  int nparts;            // boxes of a slice
  int row_step;          // bytes between pixel rows of a block (a box row)
  int halo_tx;           // bytes TMA writes into one halo stage
  uint32_t lo_mask;      // 0xffffffff (3xTF32) or 0 (1xTF32 control)
  int part_y[kMaxPart];  // each box's residue row and column
  int part_x[kMaxPart];
  int win_off[kMaxWin];  // window ky*Wk + kx -> byte shift in the halo
};

// one launch as the wrapper packs it (`Tf32WgradArgs`): the pointers and
// the stream per call, the rest once per geometry
struct Args {
  const void* x;
  const void* dy;
  float* dw;
  float* ws;             // splits x Hk*Wk*Ci x Co words, or null
  void* stream;
  int B, H, W, Ho, Wo;   // x (B, H, W, Ci), dy (B, Ho, Wo, Co)
  int box_y, box_x;      // the x box in the tensor (traversal stride included)
  int es_y, es_x;        // the x map's traversal strides
  int bn, nwc, splits, smem_bytes;
  Geom g;
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

__device__ __forceinline__ void sts4(uint32_t a, const uint32_t* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// the split of v: hi its top 19 bits (sign, exponent, 10 mantissa bits:
// a TF32 value exactly, so the tensor cores read it unchanged whether
// they truncate or round an operand's low 13 bits), lo = v - hi, exact in
// f32 and read as TF32 in turn (its own error under 2^-20 of v).  mask 0
// drops lo (the 1xTF32 control)
__device__ __forceinline__ void split_tf32(float v, uint32_t mask,
                                           uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & mask;
}

__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
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

// one 4-D TMA box into shared memory, completing on `bar`
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

// make this thread's shared-memory writes visible to wgmma (the async
// proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), the 128-byte swizzle.  K-major
// with the swizzle: 8 rows of 128 bytes an atom (stride offset 1024),
// the leading offset unused; a k8 step 32 bytes further along the row
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

// d (64 x 64 f32) += A (64 x 8 tf32, registers) B (8 x 64 tf32, K-major
// in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 8 tf32, registers) B (8 x 128 tf32, K-major
// in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, const uint32_t* a,
                                           uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, db);
  else
    wgmma_n128(d, a, db);
}

// BN: dW columns (output channels) per CTA; NWC: row blocks of 64 dW
// rows per consumer, both constants so that the steps unroll and the
// sums and A fragments stay in registers
template <int BN, int NWC>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_lb_sm90_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_dy,
                          float* __restrict__ out,
                          const __grid_constant__ Geom g) {
  extern __shared__ uint8_t smem_raw[];
  // from a 1024-byte line (the swizzle atom): the TMA ring (per stage the
  // dy tile, BN/32 boxes of 8 KB, then cib/32 halo boxes), the B ring
  // (per stage the hi tile, then the lo tile, each two 32-pixel halves
  // of BN rows of 128 bytes), then the mbarriers
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  constexpr uint32_t dy_bytes = BN * kBlock * kBlock * 4;
  constexpr uint32_t bt_bytes = BN * kBlock * kBlock * 4;
  const uint32_t stage_bytes = dy_bytes + (g.cib / kBox) * g.sub_bytes;
  const uint32_t b_ring = ring + g.stages * stage_bytes;
  const uint32_t bars = b_ring + kBStages * 2 * bt_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (g.stages + s); };
  auto bfull = [&](int s) { return bars + 8 * (2 * g.stages + s); };
  auto bempty = [&](int s) {
    return bars + 8 * (2 * g.stages + kBStages + s);
  };

  const int cb = blockIdx.x / g.ngrp;   // Ci block
  const int grp = blockIdx.x % g.ngrp;  // row-block group within it
  const int n0 = blockIdx.y * BN;
  const int blk0 = blockIdx.z * g.bps;
  const int nsteps = min(g.nblk, blk0 + g.bps) - blk0;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
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
      // the producer: one thread keeps the TMA ring full; the first
      // pass finds every stage empty (the parity before the first phase)
      if (lane != 0) return;
      const int per_img = g.nby * g.nbx;
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nsteps; ++i) {
        const int blk = blk0 + i;
        const int b = blk / per_img;
        const int r = blk - b * per_img;
        const int oy0 = (r / g.nbx) * kBlock, ox0 = (r % g.nbx) * kBlock;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), dy_bytes + g.halo_tx);
        const uint32_t dst = ring + s * stage_bytes;
        for (int j = 0; j < BN / kBox; ++j)
          tma_load4(dst + j * 8192, &map_dy, full(s), n0 + kBox * j, ox0,
                    oy0, b);
        for (int p = 0; p < g.cib / kBox; ++p)
          for (int q = 0; q < g.nparts; ++q)
            tma_load4(dst + dy_bytes + p * g.sub_bytes + q * g.part_bytes,
                      &map_x, full(s), cb * g.cib + kBox * p,
                      g.sx * ox0 - g.px + g.part_x[q],
                      g.sy * oy0 - g.py + g.part_y[q], b);
        if (++s == g.stages) {
          s = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // the transposers: per pixel block, dy[pixel][co] (N-major, as TMA
    // brings it) -> hi and lo [co][pixel] (K-major).  A unit is one
    // 32-channel box (a lane a channel) and 4 pixels of one parity of
    // one output row: four conflict-free 4-byte loads, one 16-byte store
    // each of hi and lo (8 lanes cover the 8 rows of an atom: no
    // conflict)
    const int tw = warp - 1;
    int s = 0, bs = 0;
    uint32_t phase = 0, bphase = 0;
    for (int i = 0; i < nsteps; ++i) {
      mbar_wait(full(s), phase);
      mbar_wait(bempty(bs), bphase ^ 1);
      const uint32_t src = ring + s * stage_bytes;
      const uint32_t dst = b_ring + bs * 2 * bt_bytes;
      for (int u = tw; u < (BN / kBox) * 2 * kBlock; u += kTransposers) {
        const int nb = u / (2 * kBlock), q = u % (2 * kBlock);
        const int j = q / 2, h = q % 2;  // output row, pixel parity
        const int n = nb * kBox + lane;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float v = lds(swz(src + nb * 8192 +
                                  (j * kBlock + 2 * t + h) * 128 + lane * 4));
          split_tf32(v, g.lo_mask, hi[t], lo[t]);
        }
        const uint32_t d = dst + (j / 4) * (BN * 128) + n * 128 +
                           ((((j % 4) * 2 + h) ^ (n % 8)) << 4);
        sts4(d, hi);
        sts4(d + bt_bytes, lo);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty(s));
        mbar_arrive(bfull(bs));
      }
      if (++s == g.stages) {
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
  const int cw = wg - 1;
  const int w16 = 16 * ((threadIdx.x % 128) / 32);  // this warp's rows
  // this consumer's row blocks: (channel slice, window group) pairs of
  // the Ci block, slice-major.  The warp's 16 rows are 16 channels of one
  // window; this thread's rows w16 + lane/4 and w16 + lane/4 + 8 are its
  // channels 2 (lane/4) and 2 (lane/4) + 1.  A block past the last
  // repeats the last one's reads and is not stored; a window past the
  // last reads window 0's
  uint32_t a_off[NWC];
  int rb[NWC];
#pragma unroll
  for (int j = 0; j < NWC; ++j) {
    rb[j] = (grp * kConsumers + cw) * NWC + j;
    const int r = min(rb[j], g.nrb - 1);
    int win = (r % g.nwg) * (64 / g.cpr) + w16 / g.cpr;
    if (win >= g.nwin) win = 0;
    const int ch = (r / g.nwg) * g.cpr + w16 % g.cpr + 2 * (lane / 4);
    a_off[j] = (ch / kBox) * g.sub_bytes + g.win_off[win] +
               (ch % kBox) * 4 + (lane % 4) * 256;
  }
  // zeroed by an opaque move: a plain 0.f assignment lets the compiler
  // fold the zeros into the first group and serialize every wgmma
  float acc[NWC][BN / 2];
#pragma unroll
  for (int j = 0; j < NWC; ++j)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      asm volatile("mov.b32 %0, 0;\n" : "=f"(acc[j][i]));

  // A fragments in four buffers across k8 steps: [hi a0..a3, lo a0..a3]
  uint32_t af[4][NWC][8];
  int s = 0, bs = 0, prev_bs = 0;
  uint32_t phase = 0, bphase = 0;
  for (int step = 0; step < nsteps; ++step) {
    mbar_wait(full(s), phase);
    mbar_wait(bfull(bs), bphase);
    const uint32_t hb = ring + s * stage_bytes + dy_bytes;
    const uint32_t bb = b_ring + bs * 2 * bt_bytes;
#pragma unroll
    for (int kk = 0; kk < kBlock; ++kk) {
      const int f = kk % 4;
#pragma unroll
      for (int j = 0; j < NWC; ++j) {
        // a0 (row r, pixel 2t), a1 (row r + 8, 2t), a2 (r, 2t + 1),
        // a3 (r + 8, 2t + 1) of output row kk: rows r and r + 8 are
        // adjacent channels, one 8-byte load a pixel
        const uint32_t a = hb + a_off[j] + kk * g.row_step;
        const float2 p0 = lds2(swz(a));
        const float2 p1 = lds2(swz(a + 128));
        split_tf32(p0.x, g.lo_mask, af[f][j][0], af[f][j][4]);
        split_tf32(p0.y, g.lo_mask, af[f][j][1], af[f][j][5]);
        split_tf32(p1.x, g.lo_mask, af[f][j][2], af[f][j][6]);
        split_tf32(p1.y, g.lo_mask, af[f][j][3], af[f][j][7]);
      }
      const uint64_t dhi =
          gmma_desc(bb + (kk / 4) * (BN * 128) + (kk % 4) * 32);
      const uint64_t dlo =
          gmma_desc(bb + bt_bytes + (kk / 4) * (BN * 128) + (kk % 4) * 32);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NWC; ++j) {
        wgmma_tile<BN>(acc[j], &af[f][j][4], dhi);   // lo * hi
        wgmma_tile<BN>(acc[j], &af[f][j][0], dlo);   // hi * lo
        wgmma_tile<BN>(acc[j], &af[f][j][0], dhi);   // hi * hi
      }
      wgmma_commit();
      // at most this step and the one before in flight: the fragments of
      // the step before that may be overwritten; at a block's second
      // step the last of the block before has retired, and its B tiles
      // are free
      wgmma_wait<2>();
      if (kk == 1 && step > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bempty(prev_bs));
      }
    }
    // every fragment of this block is in registers: the halo is free
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    prev_bs = bs;
    if (++s == g.stages) {
      s = 0;
      phase ^= 1;
    }
    if (++bs == kBStages) {
      bs = 0;
      bphase ^= 1;
    }
  }
  wgmma_wait<0>();

  // one write of the tile: to dW, or to this split's workspace slice.
  // Thread t of warp v holds rows 16v + t/4 (acc 4q, 4q+1) and
  // 16v + t/4 + 8 (4q+2, 4q+3), columns 8q + 2(t%4), +1: channels
  // 2 (t/4) and 2 (t/4) + 1 of the warp's 16
  const size_t m_rows = static_cast<size_t>(g.nwin) * g.Ci;
  float* dst = out + blockIdx.z * m_rows * g.Co;
#pragma unroll
  for (int j = 0; j < NWC; ++j) {
    if (rb[j] >= g.nrb) continue;
    const int win = (rb[j] % g.nwg) * (64 / g.cpr) + w16 / g.cpr;
    if (win >= g.nwin) continue;
    const int ci = cb * g.cib + (rb[j] / g.nwg) * g.cpr + w16 % g.cpr +
                   2 * (lane / 4);
    const bool ok0 = ci < g.Ci, ok1 = ci + 1 < g.Ci;
    float* r0 = dst + (static_cast<size_t>(win) * g.Ci + ci) * g.Co;
    float* r1 = r0 + g.Co;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      // Co % 4 == 0 and co even: the pair is in range or not as one
      const int co = n0 + 8 * q + 2 * (lane % 4);
      if (co >= g.Co) continue;
      if (ok0)
        *reinterpret_cast<float2*>(r0 + co) =
            make_float2(acc[j][4 * q], acc[j][4 * q + 1]);
      if (ok1)
        *reinterpret_cast<float2*>(r1 + co) =
            make_float2(acc[j][4 * q + 2], acc[j][4 * q + 3]);
    }
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// second pass: dW[i] = sum over splits of the workspace, in split order
// (n % 4 == 0, 16-byte aligned slices).  A small dW (VGG16's conv1_1: 512
// float4 over 131 splits) leaves each thread a long chain of loads, so
// eight are in flight at a time; the adds keep split order
__global__ void wgrad_tf32_reduce_kernel(const float4* __restrict__ ws,
                                         float4* __restrict__ out, size_t n4,
                                         int splits) {
  constexpr int kAhead = 8;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) +
                  threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 s = __ldg(ws + i);
    int p = 1;
    for (; p + kAhead <= splits; p += kAhead) {
      float4 v[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        v[q] = __ldg(ws + static_cast<size_t>(p + q) * n4 + i);
#pragma unroll
      for (int q = 0; q < kAhead; ++q) add4(s, v[q]);
    }
    for (; p < splits; ++p)
      add4(s, __ldg(ws + static_cast<size_t>(p) * n4 + i));
    out[i] = s;
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

// an f32 map of 4 dimensions (innermost first) over an NHWC tensor (C,
// W, H, B), boxes of `box` traversed at `elem` (the box holds box[i] /
// elem[i] elements along i), 128-byte swizzle, zero fill out of bounds.
// A map is a pure function of these, so the last kMapCache of them are
// kept and a key seen before is not encoded again
struct MapKey {
  const void* base;
  cuuint64_t dims[4];
  cuuint32_t box[4];
  cuuint32_t elem[4];
};

struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};

int make_map(CUtensorMap* map, const void* base, int C, int W, int H, int B,
             const cuuint32_t* box, const cuuint32_t* elem) {
  static MapSlot slots[kMapCache];
  static int next = 0;
  MapKey key;
  memset(&key, 0, sizeof key);
  key.base = base;
  key.dims[0] = C;
  key.dims[1] = W;
  key.dims[2] = H;
  key.dims[3] = B;
  for (int i = 0; i < 4; ++i) {
    key.box[i] = box[i];
    key.elem[i] = elem[i];
  }
  for (int i = 0; i < kMapCache; ++i)
    if (slots[i].used && memcmp(&slots[i].key, &key, sizeof key) == 0) {
      *map = slots[i].map;
      return 0;
    }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t strides[3] = {4ull * C, 4ull * C * W, 4ull * C * W * H};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
      key.dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  MapSlot& slot = slots[next];
  next = (next + 1) % kMapCache;
  slot.key = key;
  slot.map = *map;
  slot.used = true;
  return 0;
}

template <int BN, int NWC>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mdy, float* dst,
                   const Geom& g, int co_blocks, int splits, int smem_bytes,
                   cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if (smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_lb_sm90_tf32_kernel<BN, NWC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = smem_bytes;
  }
  const int ncb = (g.Ci + g.cib - 1) / g.cib;
  const dim3 grid(ncb * g.ngrp, co_blocks, splits);
  wgrad_lb_sm90_tf32_kernel<BN, NWC><<<grid, kThreads, smem_bytes, stream>>>(
      mx, mdy, dst, g);
  return cudaGetLastError();
}

cudaError_t launch_tile(int bn, int nwc, const CUtensorMap& mx,
                        const CUtensorMap& mdy, float* dst, const Geom& g,
                        int splits, int smem_bytes, cudaStream_t s) {
  const int nco = (g.Co + bn - 1) / bn;
  if (bn == 128 && nwc == 1)
    return launch<128, 1>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  if (bn == 64 && nwc == 2)
    return launch<64, 2>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  if (bn == 64 && nwc == 1)
    return launch<64, 1>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dW (Hk, Wk, Ci, Co) f32 from x (B, H, W, Ci) and dy (B, Ho, Wo, Co),
// one launch from `a` (the wrapper's `Tf32WgradArgs`): contiguous f32,
// bases 16-byte aligned, Ci and Co multiples of 4 (the wrapper's route
// checks all of it).  The tile (bn, nwc, cib, cpr), the ring depth, the
// halo's boxes and steps, the split (splits ranges of bps pixel blocks)
// and every window's shift come from the wrapper's plan.  With splits > 1
// the partial tiles go to `ws` and a second kernel sums them into `dw`.
// Returns a CUDA error code, or 1000 + the CUresult of a refused tensor
// map, or -1 if the driver has no cuTensorMapEncodeTiled.
// (`args` is an `Args`, whose type is this file's own: the entry takes it
// as a plain pointer so that its name is exported)
extern "C" int wgrad_lb_sm90_tf32_launch(const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  const Geom& g = a.g;
  if (a.B < 1 || g.Ci < 1 || g.Co < 1 || g.Ci % 4 || g.Co % 4 ||
      g.nwin < 1 || g.nwin > kMaxWin ||
      (g.cib != 32 && g.cib != 64 && g.cib != 128) ||
      (g.cpr != 16 && g.cpr != 32 && g.cpr != 64) || g.cpr > g.cib ||
      g.stages < 2 || g.stages > kMaxStages || g.part_bytes % 1024 != 0 ||
      g.nparts < 1 || g.nparts > kMaxPart ||
      g.sub_bytes < g.nparts * g.part_bytes || a.box_y > 256 ||
      a.box_x > 256 || a.es_y < 1 || a.es_y > 8 || a.es_x < 1 ||
      a.es_x > 8 || a.splits < 1 || g.bps < 1 ||
      static_cast<long long>(a.splits - 1) * g.bps >= g.nblk ||
      static_cast<long long>(a.splits) * g.bps < g.nblk ||
      (a.splits > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // x: 32 channels of one halo box per load; dy: 32 channels of one 8 x 8
  // pixel block per box; both 128-byte swizzled
  const cuuint32_t x_box[4] = {kBox, static_cast<cuuint32_t>(a.box_x),
                               static_cast<cuuint32_t>(a.box_y), 1};
  const cuuint32_t x_elem[4] = {1, static_cast<cuuint32_t>(a.es_x),
                                static_cast<cuuint32_t>(a.es_y), 1};
  const cuuint32_t dy_box[4] = {kBox, kBlock, kBlock, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap mx, mdy;
  int err = make_map(&mx, a.x, g.Ci, a.W, a.H, a.B, x_box, x_elem);
  if (err) return err;
  err = make_map(&mdy, a.dy, g.Co, a.Wo, a.Ho, a.B, dy_box, unit);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  float* dst = a.splits > 1 ? a.ws : a.dw;
  cudaError_t e =
      launch_tile(a.bn, a.nwc, mx, mdy, dst, g, a.splits, a.smem_bytes, s);
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  const size_t n4 = static_cast<size_t>(g.nwin) * g.Ci * g.Co / 4;
  const int blocks =
      static_cast<int>((n4 + 127) / 128 < 4096 ? (n4 + 127) / 128 : 4096);
  wgrad_tf32_reduce_kernel<<<blocks, 128, 0, s>>>(
      reinterpret_cast<const float4*>(a.ws), reinterpret_cast<float4*>(a.dw),
      n4, a.splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgrad_lb_sm90_tf32_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
