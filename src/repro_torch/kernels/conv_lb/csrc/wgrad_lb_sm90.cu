// Weight gradient of an NHWC convolution in bf16 on Hopper's tensor
// cores (sm_90a), stride 1:
//
//   dW[ky, kx, ci, co] = sum_{b, oy, ox}
//       x[b, oy + ky*dly - py, ox + kx*dlx - px, ci] * dy[b, oy, ox, co]
//
// (x read as zero outside the plane.)  bf16 x and dy, f32 sums, f32 dW
// (as the reference's wgrad returns it).
//
// Replaces, with csrc/wgrad_lb.cu (which keeps f32, strides and the
// bf16 layouts TMA cannot describe), the TPU kernel `_wgrad_kernel`
// launched by `wgrad_lb_call` (src/repro/kernels/conv_lb/wgrad.py:50,
// :94).  It computes the same function; it is not a block-by-block
// copy of it.
//
// The product.  dW is a (Hk*Wk*Ci) x Co matrix, the GEMM of M = Hk*Wk*Ci
// rows (window, ci), N = Co columns, over K = B*Ho*Wo output pixels
// (the batch folds into the reduction).
//
// What bounds it on this card.  VGG's 3x3 layers after conv1_1 do
// 2*9*Ci*Co operations per reduction pixel against (Ci + Co) * 2 bytes
// read per pixel: hundreds to thousands of operations per byte, above
// the card's bf16 balance (989 TFLOP/s over 3.35 TB/s, about 295 per
// byte), so the tensor-core rate bounds them.  dW is small and the
// reduction long (conv1_2: 576 x 64 words over 401,408 pixels; conv5_x:
// 4608 x 512 over 1,568).
//
// What the design does about it.
//  * The dW tile stays in registers over the CTA's whole pixel range
//    (the paper's OutR on the weight gradient): two consumer warpgroups
//    each hold NWC row blocks of 64 rows x BN columns (NWC * BN <= 256,
//    at most 128 f32 a thread) and run wgmma.mma_async m64nBNk16 on
//    them; one producer thread issues every TMA load.
//  * The K step is an 8 x 8 block of output pixels of one image (four
//    k16 steps, each two output rows).  A stage of the ring holds its
//    dy tile and the x halo every window of the CTA reads.
//  * A, the input, as a halo served to every window from shared memory
//    (WndR): per pixel block and 64-channel slice one 4-D TMA load over
//    (Ci, W, H, B) brings the (8 + (Hk-1)*dly) x (8 + (Wk-1)*dlx) halo
//    in tiled mode with signed coordinates, so padding and ragged edges
//    arrive as TMA's out-of-bounds zeros and no padded copy of x is
//    made.  Here the channels are M and the pixels K: a box laid out
//    [hy][hx][64], one 128-byte row per pixel with the 128-byte
//    swizzle, is an MN-major operand; wgmma reads it transposed
//    (imm-trans-a, bf16 and A in shared memory only), 8 consecutive
//    pixels of a halo row a K group, the next output row one halo row
//    further (the descriptor's stride offset), and window (ky, kx) the
//    same descriptor shifted by (ky*dly*hx + kx*dlx)*128 bytes.  The
//    swizzle follows the absolute address, so the shifted reads see
//    what TMA wrote.  (Eight unswizzled planes of 8 channels, as
//    conv_lb_sm90.cu stages its halo, make TMA move 16-byte rows, which
//    held this kernel back.)  A CTA's row blocks are (64-channel slice,
//    window) pairs of one Ci block of `cib` channels (64 or 128), all
//    read from one halo; the wrapper passes every offset.
//  * The split ranges are short (at most 256 pixel blocks): the tensor
//    cores' f32 sums drift with the length of a range, and a whole
//    VGG conv1_2 reduction in one range misses the wgrad tolerance.
//  * B, the incoming gradient, N-major: per block BN/64 4-D TMA loads
//    over (Co, Wo, Ho, B), boxes of 64 channels x 8 x 8 pixels with the
//    128-byte swizzle, read MN-major (imm-trans-b) as conv_lb_sm90.cu
//    reads its weights.  Pixels past Wo or Ho arrive as dy = 0, so the
//    (finite, in-plane) x words they meet add nothing; channels past Ci
//    or Co arrive as zeros and are masked on store.
//  * The reduction is split over CTAs into contiguous ranges of pixel
//    blocks, chosen by the wrapper's plan to fill the card's 132 SMs.
//    Each CTA writes its tile once, to dW or to its split's workspace
//    slice; a second pass sums the slices in split order, so two runs
//    give the same bits (no atomics).
//  * The producer warpgroup gives its registers to the consumers
//    (setmaxnreg); the sums are zeroed by an opaque move so that ptxas
//    does not serialize wgmma.
//  * No persistence, no clusters, no TMA store yet.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;   // warpgroups, NWC row blocks each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlock = 8;       // a K step: kBlock x kBlock output pixels
constexpr int kMaxWin = 128;    // windows whose offsets a launch carries
constexpr int kMaxStages = 8;   // ring stages (dy tile + halo)

struct Geom {
  int Ci, Co, nwin;
  int py, px;            // the halo of block (oy0, ox0) starts at (oy0-py, ox0-px)
  int nby, nbx;          // pixel blocks along Ho, Wo
  int nblk;              // B * nby * nbx
  int bps;               // pixel blocks per split
  int cib;               // channels per Ci block (64 or 128)
  int nrb;               // row blocks per Ci block: nwin * cib / 64
  int ngrp;              // CTA row-block groups per Ci block
  int stages;            // ring depth
  int sub_bytes;         // one 64-channel halo box (a 1024-byte multiple)
  int sbo;               // one halo row: A's stride offset
  int halo_tx;           // bytes TMA writes into one halo stage
  int win_off[kMaxWin];  // window ky*Wk + kx -> byte shift in the halo
};

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

// wait until the phase of `bar` with this parity has completed; a wait
// that never ends (a transaction count that cannot be met) traps, so a
// fault ends the launch with an error instead of holding the card
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

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the layout: 128-byte swizzle
// or none.  The swizzle is a function of the absolute shared-memory
// address (as TMA writes it), so a start address moved by whole
// 128-byte rows inside a 1024-byte atom needs no base offset
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, bool swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle ? 1 : 0) << 62);
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

// d (64 x n f32 fragment) += A (64 x 16, MN-major) B (16 x n, MN-major)
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
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
      "%128, %129, p, 1, 1, 1, 1;\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n256(d, da, db);
}

// BN: dW columns (output channels) per CTA; NWC: row blocks of 64 dW
// rows per consumer, both constants so that the wgmma steps unroll and
// the sums stay in registers
template <int BN, int NWC>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_lb_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_dy,
                     float* __restrict__ out,
                     const __grid_constant__ Geom g) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align the ring to it (each
  // stage's dy tile is a multiple of 8 KB, each halo box of 1 KB); the
  // mbarriers follow
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t dy_ring = (raw + 1023) & ~1023u;
  constexpr uint32_t dy_stage = BN * kBlock * kBlock * 2;
  const uint32_t h_ring = dy_ring + g.stages * dy_stage;
  const uint32_t h_stage = (g.cib / 64) * g.sub_bytes;
  const uint32_t bars = h_ring + g.stages * h_stage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (g.stages + s); };

  const int cb = blockIdx.x / g.ngrp;   // Ci block
  const int grp = blockIdx.x % g.ngrp;  // row-block group within it
  const int n0 = blockIdx.y * BN;
  const int blk0 = blockIdx.z * g.bps;
  const int nsteps = min(g.nblk, blk0 + g.bps) - blk0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full; the first pass finds
    // every stage empty (the parity of the phase before the first)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int per_img = g.nby * g.nbx;
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nsteps; ++i) {
        const int blk = blk0 + i;
        const int b = blk / per_img;
        const int r = blk - b * per_img;
        const int oy0 = (r / g.nbx) * kBlock, ox0 = (r % g.nbx) * kBlock;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), dy_stage + g.halo_tx);
        const uint32_t dst = dy_ring + s * dy_stage;
        // BN/64 boxes of 64 channels x 8 x 8 pixels, 8 KB each
        for (int j = 0; j < BN / 64; ++j)
          tma_load4(dst + j * 8192, &map_dy, full(s), n0 + 64 * j, ox0, oy0,
                    b);
        const uint32_t hdst = h_ring + s * h_stage;
        for (int p = 0; p < g.cib / 64; ++p)
          tma_load4(hdst + p * g.sub_bytes, &map_x, full(s),
                    cb * g.cib + 64 * p, ox0 - g.px, oy0 - g.py, b);
        if (++s == g.stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    // this consumer's row blocks: (64-channel slice, window) pairs of
    // the Ci block, slice-major, each a halo box and a window's shift; a
    // block past the last repeats the last one's reads and is not stored
    uint32_t a_off[NWC];
    int rb[NWC];
#pragma unroll
    for (int j = 0; j < NWC; ++j) {
      rb[j] = (grp * kConsumers + cw) * NWC + j;
      const int r = min(rb[j], g.nrb - 1);
      a_off[j] = (r / g.nwin) * g.sub_bytes + g.win_off[r % g.nwin];
    }
    // zeroed by an opaque move: a plain 0.f assignment lets the compiler
    // fold the zeros into the first group and serialize every wgmma
    float acc[NWC][BN / 2];
#pragma unroll
    for (int j = 0; j < NWC; ++j)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        asm volatile("mov.b32 %0, 0;\n" : "=f"(acc[j][i]));

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int step = 0; step < nsteps; ++step) {
      mbar_wait(full(s), phase);
      const uint32_t a_base = h_ring + s * h_stage;
      const uint32_t b_base = dy_ring + s * dy_stage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 2; ++kk) {
        // B: 64-channel boxes 8 KB apart (leading), 8-pixel K groups
        // 1024 bytes apart (stride), a k16 step 16 pixel rows
        const uint64_t db =
            gmma_desc(b_base + kk * 2048, 8192, 1024, true);
#pragma unroll
        for (int j = 0; j < NWC; ++j) {
          // A: 64 channels (one 128-byte swizzled row per pixel), a k16
          // step two output rows, 8-pixel K groups one halo row apart
          // (stride; the leading offset is unused at 64 rows)
          const uint64_t da = gmma_desc(a_base + a_off[j] + kk * 2 * g.sbo,
                                        8192, g.sbo, true);
          wgmma_tile<BN>(acc[j], da, db);
        }
      }
      wgmma_commit();
      if (step > 0) {
        // the previous group has retired: release its stage
        wgmma_wait<1>();
        if (threadIdx.x % 32 == 0) mbar_arrive(empty(prev));
      }
      prev = s;
      if (++s == g.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();

    // one write of the tile: to dW, or to this split's workspace slice.
    // Thread t of warp v holds rows 16v + t/4 (acc 4q, 4q+1) and
    // 16v + t/4 + 8 (4q+2, 4q+3), columns 8q + 2(t%4), +1
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const size_t m_rows = static_cast<size_t>(g.nwin) * g.Ci;
    float* dst = out + blockIdx.z * m_rows * g.Co;
#pragma unroll
    for (int j = 0; j < NWC; ++j) {
      if (rb[j] >= g.nrb) continue;
      const int win = rb[j] % g.nwin;
      const int ci = cb * g.cib + (rb[j] / g.nwin) * 64 + 16 * (tid / 32) +
                     lane / 4;
      const bool ok0 = ci < g.Ci, ok1 = ci + 8 < g.Ci;
      float* row0 = dst + (static_cast<size_t>(win) * g.Ci + ci) * g.Co;
      float* row1 = row0 + 8 * static_cast<size_t>(g.Co);
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        // Co % 8 == 0: a warp's 8-column group is in range or not as one
        const int co = n0 + 8 * q + 2 * (lane % 4);
        if (n0 + 8 * q >= g.Co) continue;
        if (ok0)
          *reinterpret_cast<float2*>(row0 + co) =
              make_float2(acc[j][4 * q], acc[j][4 * q + 1]);
        if (ok1)
          *reinterpret_cast<float2*>(row1 + co) =
              make_float2(acc[j][4 * q + 2], acc[j][4 * q + 3]);
      }
    }
  }
}

// second pass: dW[i] = sum over splits of the workspace, in split order
// (n % 4 == 0, 16-byte aligned slices)
__global__ void wgrad_sm90_reduce_kernel(const float4* __restrict__ ws,
                                         float4* __restrict__ out, size_t n4,
                                         int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) +
                  threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 s = ws[i];
    for (int p = 1; p < splits; ++p) {
      const float4 v = ws[static_cast<size_t>(p) * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
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

// a bf16 map of 4 dimensions (innermost first) over an NHWC tensor
// (C, W, H, B), boxes of `box`, zero fill out of bounds
int make_map(CUtensorMap* map, const void* base, int C, int W, int H, int B,
             const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int BN, int NWC>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mdy, float* dst,
                   const Geom& g, int co_blocks, int splits, int smem_bytes,
                   cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if (smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_lb_sm90_kernel<BN, NWC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = smem_bytes;
  }
  const int ncb = (g.Ci + g.cib - 1) / g.cib;
  const dim3 grid(ncb * g.ngrp, co_blocks, splits);
  wgrad_lb_sm90_kernel<BN, NWC><<<grid, kThreads, smem_bytes, stream>>>(
      mx, mdy, dst, g);
  return cudaGetLastError();
}

cudaError_t launch_tile(int bn, int nwc, const CUtensorMap& mx,
                        const CUtensorMap& mdy, float* dst, const Geom& g,
                        int splits, int smem_bytes, cudaStream_t s) {
  const int nco = (g.Co + bn - 1) / bn;
  if (bn == 256 && nwc == 1)
    return launch<256, 1>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  if (bn == 128 && nwc == 1)
    return launch<128, 1>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  if (bn == 128 && nwc == 2)
    return launch<128, 2>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  if (bn == 64 && nwc == 1)
    return launch<64, 1>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  if (bn == 64 && nwc == 3)
    return launch<64, 3>(mx, mdy, dst, g, nco, splits, smem_bytes, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dW (Hk, Wk, Ci, Co) f32 from x (B, H, W, Ci) and dy (B, Ho, Wo, Co):
// contiguous bf16, bases 16-byte aligned, Ci and Co multiples of 8,
// stride 1 (the wrapper's route checks all of it).  The tile (bn, nwc,
// cib), the ring depth, the halo box (hy, hx), the split (splits ranges
// of bps pixel blocks) and every shared-memory offset come from the
// wrapper's plan: sub_bytes (one 64-channel halo box), sbo (one halo
// row: A's stride offset) and win_off (Hk*Wk window shifts, host
// memory).  With
// splits > 1 the partial tiles go to `ws` (splits x Hk*Wk*Ci x Co
// words) and a second kernel sums them into `dw`.  Returns a CUDA error
// code, or 1000 + the CUresult of a refused tensor map, or -1 if the
// driver has no cuTensorMapEncodeTiled.
extern "C" int wgrad_lb_sm90_forward(
    const void* x, const void* dy, float* dw, float* ws, const void* win_off,
    int B, int H, int W, int Ci, int Co, int Hk, int Wk, int Ho, int Wo,
    int py, int px, int hy, int hx, int bn, int nwc, int cib, int stages,
    int sub_bytes, int sbo, int splits, int bps, int smem_bytes,
    void* stream) {
  const int nwin = Hk * Wk;
  const int nblk = B * ((Ho + kBlock - 1) / kBlock) *
                   ((Wo + kBlock - 1) / kBlock);
  if (B < 1 || Ci < 1 || Co < 1 || Ci % 8 || Co % 8 || nwin < 1 ||
      nwin > kMaxWin || (cib != 64 && cib != 128) || stages < 2 ||
      stages > kMaxStages || sub_bytes % 1024 != 0 ||
      sub_bytes < hy * hx * 128 || sbo != hx * 128 || splits < 1 ||
      bps < 1 || static_cast<long long>(splits - 1) * bps >= nblk ||
      static_cast<long long>(splits) * bps < nblk ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.Ci = Ci; g.Co = Co; g.nwin = nwin;
  g.py = py; g.px = px;
  g.nby = (Ho + kBlock - 1) / kBlock;
  g.nbx = (Wo + kBlock - 1) / kBlock;
  g.nblk = nblk;
  g.bps = bps;
  g.cib = cib;
  g.nrb = nwin * (cib / 64);
  g.ngrp = (g.nrb + kConsumers * nwc - 1) / (kConsumers * nwc);
  g.stages = stages;
  g.sub_bytes = sub_bytes;
  g.sbo = sbo;
  g.halo_tx = (cib / 64) * hy * hx * 128;
  const int* offs = static_cast<const int*>(win_off);
  for (int i = 0; i < kMaxWin; ++i) g.win_off[i] = i < nwin ? offs[i] : 0;

  // x: 64 channels of the halo per box; dy: 64 channels of one 8 x 8
  // pixel block per box; both 128-byte swizzled
  const cuuint32_t x_box[4] = {64, static_cast<cuuint32_t>(hx),
                               static_cast<cuuint32_t>(hy), 1};
  const cuuint32_t dy_box[4] = {64, kBlock, kBlock, 1};
  CUtensorMap mx, mdy;
  int err = make_map(&mx, x, Ci, W, H, B, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = make_map(&mdy, dy, Co, Wo, Ho, B, dy_box,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? ws : dw;
  cudaError_t e =
      launch_tile(bn, nwc, mx, mdy, dst, g, splits, smem_bytes, s);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n4 = static_cast<size_t>(nwin) * Ci * Co / 4;
  const int blocks =
      static_cast<int>((n4 + 255) / 256 < 2048 ? (n4 + 255) / 256 : 2048);
  wgrad_sm90_reduce_kernel<<<blocks, 256, 0, s>>>(
      reinterpret_cast<const float4*>(ws), reinterpret_cast<float4*>(dw), n4,
      splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgrad_lb_sm90_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
