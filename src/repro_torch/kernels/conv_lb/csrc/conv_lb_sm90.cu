// Batch-folded NHWC convolution in bf16 on Hopper's tensor cores
// (sm_90a), stride 1, with the fused bias -> residual -> ReLU -> 2x2
// max-pool epilogue: bf16 in, f32 sums, bf16 out.
//
// Replaces, with csrc/conv_lb.cu (which keeps f32, strides, lhs
// dilation and the bf16 layouts TMA cannot describe), the TPU kernel
// `_conv_kernel` launched by `conv_lb_call`
// (src/repro/kernels/conv_lb/kernel.py:116, :177).  It computes the
// same function; it is not a block-by-block copy of it.
//
// What bounds it on this card.  VGG's 3x3 layers do 2*9*Ci operations
// per output word against a few bytes moved per word: hundreds to
// thousands of operations per byte, above the card's bf16 balance
// (989 TFLOP/s over 3.35 TB/s, about 295 per byte) from Ci = 64 on, so
// the tensor-core rate bounds them.
//
// What the design does about it.
//  * Implicit GEMM on wgmma: M = output pixels, N = Co, K = Hk*Wk*Ci.
//    A CTA owns two 64-pixel blocks, each an 8 x 8 square of output
//    pixels of one image (side by side, or in two images: the wrapper's
//    `sm90_plan`), x BN output channels (64, 128 or 256).
//    Each consumer warpgroup runs wgmma.mma_async m64nBNk16 on its
//    block; the f32 sums stay in registers over the whole (Ci block,
//    window) sweep (the paper's OutR).
//  * A, the input: per Ci block of `cib` channels the CTA stages the
//    halo-extended input tile once and serves every Hk x Wk window from
//    it (WndR): one 4-D TMA load per 8-channel plane, in tiled mode
//    with signed coordinates, so padding and ragged edges arrive as
//    TMA's out-of-bounds zeros and no padded copy of x is made.  The
//    planes lie one after another, [cib/8][bb][hy][hx][8], so 8 output
//    pixels of a row are 8 consecutive 16-byte rows: one 128-byte core
//    matrix that wgmma reads with no swizzle.  The descriptor's leading
//    offset is one plane (the K direction), its stride offset one halo
//    row (the next output row), and window (ky, kx) is the same
//    descriptor shifted by (ky*dy*hx + kx*dx)*16 bytes.  Every offset
//    is computed by the wrapper and passed in.
//  * B, the weights: a 3-D TMA map over (Co, wCi, Hk*Wk) with the
//    128-byte swizzle, read MN-major (transpose-B) as matmul_lb_sm90.cu
//    reads an N-major w; a Ci block past wCi arrives as zeros and never
//    reads the next window's rows.  wCi is Ci, or fewer: the 1x1 conv of
//    an im2col plane (route sm90_im2col, csrc/wgrad_im2col.cu) reads w
//    (Hk, Wk, Ci, Co) as its Hk*Wk*Ci rows against the plane's 32
//    channels, and the rows past them arrive as TMA's exact zeros (no
//    padded copy of w, and nothing stale times the plane's zero
//    channels).  Weights go through a ring of
//    (Ci block, window) stages, the halo through a ring of its own, two
//    stages deep, released only after every window of its Ci block has
//    retired.  One producer thread feeds each ring, so neither waits
//    for the other.
//  * The producer warpgroup gives its registers to the consumers
//    (setmaxnreg).
//  * The epilogue runs on the wgmma accumulator layout (thread t of
//    warp w holds block rows 2w, 2w + 1, column t/4, channels
//    8j + 2(t%4), +1): bias, residual and ReLU in f32 registers; a 2x2
//    pool is a max over the thread's two rows and one shuffle with the
//    neighbouring column's thread, so only pooled words are stored,
//    each rounded once to bf16 (nearest even).
//  * No persistence, no clusters, no TMA store yet.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;   // warpgroups, one 8 x 8 pixel block each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kWStages = 4;     // weight ring: (Ci block, window) stages
constexpr int kHStages = 2;     // halo ring: Ci blocks
constexpr int kMaxWin = 128;    // windows whose offsets a launch carries

struct Geom {
  int B, Ho, Wo, Co;
  int py, px;            // the halo of output (oy, ox) starts at (oy-py, ox-px)
  int bb, ty, tx;        // CTA tile: bb images x ty x tx output pixels
  int nty, ntx;          // tiles along Ho and Wo
  int ncb;               // Ci blocks (of 16, 32 or 64 channels)
  int nwin;              // Hk * Wk
  int plane_bytes;       // one 8-channel halo plane: A's leading offset
  int sbo;               // one halo row: A's stride offset
  int halo_tx;           // bytes TMA writes into one halo stage
  int pool, relu;
  int blk_off[kConsumers];  // each consumer's block inside the halo
  int win_off[kMaxWin];     // window ky*Wk + kx -> byte shift in the halo
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

// one 3-D TMA box (the weights) into shared memory, completing on `bar`
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

// one 4-D TMA box (one halo plane) into shared memory, completing on `bar`
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
// (the weights) or none (the halo's 128-byte core matrices)
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

// d (64 x n f32 fragment) += A (64 x 16, K-major) B (16 x n, MN-major)
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
      "%32, %33, p, 1, 1, 0, 1;\n"
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
      "%64, %65, p, 1, 1, 0, 1;\n"
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
      "%128, %129, p, 1, 1, 0, 1;\n"
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

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// BN: output channels per CTA; KSTEPS: wgmma k16 steps per Ci block
// (cib / 16), a constant so that the steps unroll and nothing but
// wgmma sits between a fence and its commit
template <int BN, int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
conv_lb_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __nv_bfloat16* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ res,
                    __nv_bfloat16* __restrict__ out,
                    const __grid_constant__ Geom g) {
  extern __shared__ uint8_t smem_raw[];
  // the weights' swizzle repeats every 1024 bytes: align the ring to it;
  // the halo planes follow (multiples of 128 bytes each)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t w_ring = (raw + 1023) & ~1023u;
  constexpr int kCib = 16 * KSTEPS;
  constexpr uint32_t w_stage = BN * kCib * 2;
  const uint32_t h_ring = w_ring + kWStages * w_stage;
  const uint32_t h_stage = (kCib / 8) * g.plane_bytes;
  const uint32_t bars = h_ring + kHStages * h_stage;
  auto w_full = [&](int s) { return bars + 8 * s; };
  auto w_empty = [&](int s) { return bars + 8 * (kWStages + s); };
  auto h_full = [&](int s) { return bars + 8 * (2 * kWStages + s); };
  auto h_empty = [&](int s) {
    return bars + 8 * (2 * kWStages + kHStages + s);
  };

  int t = blockIdx.x;
  const int xt = t % g.ntx;
  t /= g.ntx;
  const int yt = t % g.nty;
  const int b0 = (t / g.nty) * g.bb;
  const int oy0 = yt * g.ty, ox0 = xt * g.tx;
  const int n0 = blockIdx.y * BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), kConsumers * 4);
    }
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(h_full(s), 1);
      mbar_init(h_empty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producers: thread 0 keeps the weight ring full, thread 32 the halo
    // ring; the first pass finds every stage empty (the parity of the
    // phase before the first)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int cb = 0; cb < g.ncb; ++cb)
        for (int w = 0; w < g.nwin; ++w) {
          mbar_wait(w_empty(s), phase ^ 1);
          const uint32_t dst = w_ring + s * w_stage;
          mbar_expect_tx(w_full(s), w_stage);
          // BN/64 boxes of 64 output channels x kCib input channels
          for (int j = 0; j < BN / 64; ++j)
            tma_load3(dst + j * 64 * kCib * 2, &map_w, w_full(s),
                      n0 + 64 * j, cb * kCib, w);
          if (++s == kWStages) {
            s = 0;
            phase ^= 1;
          }
        }
    } else if (threadIdx.x == 32) {
      int s = 0;
      uint32_t phase = 0;
      for (int cb = 0; cb < g.ncb; ++cb) {
        mbar_wait(h_empty(s), phase ^ 1);
        const uint32_t dst = h_ring + s * h_stage;
        mbar_expect_tx(h_full(s), g.halo_tx);
        for (int p = 0; p < kCib / 8; ++p)
          tma_load4(dst + p * g.plane_bytes, &map_x, h_full(s),
                    cb * kCib + 8 * p, ox0 - g.px, oy0 - g.py, b0);
        if (++s == kHStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;   // this consumer's block of the CTA tile
    // zeroed by an opaque move: a plain 0.f assignment lets the compiler
    // fold the zeros into the first group and serialize every wgmma
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      asm volatile("mov.b32 %0, 0;\n" : "=f"(acc[i]));

    // one flat sweep over (Ci block, window) steps, as one loop of
    // wgmma groups: the halo of a Ci block is waited for at its first
    // window and released once its last window's group has retired
    const int nsteps = g.ncb * g.nwin;
    int w = 0, ws = 0, hs = 0, prev_ws = 0, prev_hs = 0;
    uint32_t wph = 0, hph = 0, a_blk = 0;
    bool prev_last = false;
    for (int step = 0; step < nsteps; ++step) {
      if (w == 0) {
        mbar_wait(h_full(hs), hph);
        a_blk = h_ring + hs * h_stage + g.blk_off[cw];
      }
      mbar_wait(w_full(ws), wph);
      const uint32_t a_win = a_blk + g.win_off[w];
      const uint32_t b_tile = w_ring + ws * w_stage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        // A: a k16 step is two planes; B: 64-column boxes 64*kCib*2
        // bytes apart (leading), 8-row K groups 1024 bytes apart
        // (stride), a k16 step 16 rows
        const uint64_t da = gmma_desc(a_win + kk * 2 * g.plane_bytes,
                                      g.plane_bytes, g.sbo, false);
        const uint64_t db = gmma_desc(b_tile + kk * 2048, 64 * kCib * 2,
                                      1024, true);
        wgmma_tile<BN>(acc, da, db);
      }
      wgmma_commit();
      if (step > 0) {
        // the previous group has retired: release its stages
        wgmma_wait<1>();
        if (threadIdx.x % 32 == 0) {
          mbar_arrive(w_empty(prev_ws));
          if (prev_last) mbar_arrive(h_empty(prev_hs));
        }
      }
      prev_ws = ws;
      prev_hs = hs;
      prev_last = w == g.nwin - 1;
      if (++ws == kWStages) {
        ws = 0;
        wph ^= 1;
      }
      if (++w == g.nwin) {
        w = 0;
        if (++hs == kHStages) {
          hs = 0;
          hph ^= 1;
        }
      }
    }
    wgmma_wait<0>();

    // thread t of warp v holds block rows 2v (acc 4j, 4j+1) and 2v + 1
    // (4j+2, 4j+3), block column t/4, channels 8j + 2(t%4), +1
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int b = b0 + cw * (g.bb - 1);
    const int oy = oy0 + 2 * (tid / 32);
    const int ox = ox0 + cw * (g.tx - 8) + lane / 4;
    const bool img = b < g.B;
    const bool ok0 = img && oy < g.Ho && ox < g.Wo;
    const bool ok1 = img && oy + 1 < g.Ho && ox < g.Wo;
    const size_t px0 = (static_cast<size_t>(b) * g.Ho + oy) * g.Wo + ox;
    const size_t px1 = px0 + g.Wo;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      // Co % 8 == 0: a warp's 8-channel group is in range or not as one
      const int co = n0 + 8 * j + 2 * (lane % 4);
      const bool in_co = n0 + 8 * j < g.Co;
      float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                    acc[4 * j + 3]};
      if (bias != nullptr && in_co) {
        const float2 bv = load2(bias + co);
        v[0] += bv.x;
        v[1] += bv.y;
        v[2] += bv.x;
        v[3] += bv.y;
      }
      if (res != nullptr && in_co) {
        if (ok0) {
          const float2 r = load2(res + px0 * g.Co + co);
          v[0] += r.x;
          v[1] += r.y;
        }
        if (ok1) {
          const float2 r = load2(res + px1 * g.Co + co);
          v[2] += r.x;
          v[3] += r.y;
        }
      }
      if (g.relu) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
      }
      if (g.pool == 1) {
        if (in_co && ok0) store2(out + px0 * g.Co + co, v[0], v[1]);
        if (in_co && ok1) store2(out + px1 * g.Co + co, v[2], v[3]);
      } else {
        // 2x2: rows 2v and 2v + 1 here, columns t/4 and t/4 ^ 1 in the
        // thread 4 lanes away; pooled (oy/2, ox/2) from even columns
        float m0 = fmaxf(v[0], v[2]);
        float m1 = fmaxf(v[1], v[3]);
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        if (in_co && ok0 && (lane / 4) % 2 == 0) {
          const int hp = g.Ho / 2, wp = g.Wo / 2;
          const size_t q =
              (static_cast<size_t>(b) * hp + oy / 2) * wp + ox / 2;
          store2(out + q * g.Co + co, m0, m1);
        }
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

// a bf16 map of `rank` dimensions (innermost first), strides in bytes of
// dimensions 1.., boxes of `box`, zero fill out of bounds
int make_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int BN, int KSTEPS>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw,
                   const void* bias, const void* res, void* out,
                   const Geom& g, int smem_bytes, cudaStream_t stream) {
  static int opted_in = 48 * 1024;
  if (smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_lb_sm90_kernel<BN, KSTEPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = smem_bytes;
  }
  const int nbt = (g.B + g.bb - 1) / g.bb;
  const dim3 grid(nbt * g.nty * g.ntx, (g.Co + BN - 1) / BN);
  conv_lb_sm90_kernel<BN, KSTEPS><<<grid, kThreads, smem_bytes, stream>>>(
      mx, mw, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_k(int cib, const CUtensorMap& mx, const CUtensorMap& mw,
                     const void* bias, const void* res, void* out,
                     const Geom& g, int smem_bytes, cudaStream_t stream) {
  if (cib == 64)
    return launch<BN, 4>(mx, mw, bias, res, out, g, smem_bytes, stream);
  if (cib == 32)
    return launch<BN, 2>(mx, mw, bias, res, out, g, smem_bytes, stream);
  return launch<BN, 1>(mx, mw, bias, res, out, g, smem_bytes, stream);
}

}  // namespace

// x (B, H, W, Ci), w (Hk, Wk, wCi, Co) with 1 <= wCi <= Ci (channels
// wCi .. Ci - 1 of x meet zero weights), bias (Co) or null, res (B, Ho,
// Wo, Co) or null, out (B, Ho/pool, Wo/pool, Co): contiguous bf16, bases
// 16-byte aligned, Ci and Co multiples of 8, stride 1 (the wrapper's
// route checks all of it).  The tile (bb, ty, tx, bn, cib), the halo
// box (hy, hx) and every shared-memory offset come from the wrapper's
// sm90_plan: plane_bytes (A's leading offset), sbo (A's stride offset),
// blk_off0/1 (the consumers' blocks) and win_off (Hk*Wk window shifts,
// host memory).  Returns a CUDA error code, or 1000 + the CUresult of a
// refused tensor map, or -1 if the driver has no cuTensorMapEncodeTiled.
extern "C" int conv_lb_sm90_forward(
    const void* x, const void* w, const void* bias, const void* res,
    void* out, const void* win_off, int B, int H, int W, int Ci, int wCi,
    int Co, int Hk, int Wk, int Ho, int Wo, int py, int px, int pool, int relu,
    int bb, int ty, int tx, int hy, int hx, int bn, int cib, int plane_bytes,
    int sbo, int blk_off0, int blk_off1, int smem_bytes, void* stream) {
  const int nwin = Hk * Wk;
  if (B < 1 || Ci < 1 || wCi < 1 || wCi > Ci || Co < 1 || nwin < 1 ||
      nwin > kMaxWin ||
      (pool != 1 && pool != 2) || ty != 8 || bb * tx != 16 ||
      (cib != 16 && cib != 32 && cib != 64) || plane_bytes % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.B = B; g.Ho = Ho; g.Wo = Wo; g.Co = Co;
  g.py = py; g.px = px;
  g.bb = bb; g.ty = ty; g.tx = tx;
  g.nty = (Ho + ty - 1) / ty;
  g.ntx = (Wo + tx - 1) / tx;
  g.ncb = (Ci + cib - 1) / cib;
  g.nwin = nwin;
  g.plane_bytes = plane_bytes;
  g.sbo = sbo;
  g.halo_tx = (cib / 8) * bb * hy * hx * 16;
  g.pool = pool; g.relu = relu;
  g.blk_off[0] = blk_off0;
  g.blk_off[1] = blk_off1;
  const int* offs = static_cast<const int*>(win_off);
  for (int i = 0; i < kMaxWin; ++i) g.win_off[i] = i < nwin ? offs[i] : 0;

  // x: (Ci, W, H, B), one 8-channel plane of the halo per box
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Ci),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {2ull * Ci, 2ull * Ci * W, 2ull * Ci * W * H};
  const cuuint32_t x_box[4] = {8, static_cast<cuuint32_t>(hx),
                               static_cast<cuuint32_t>(hy),
                               static_cast<cuuint32_t>(bb)};
  // w: (Co, wCi, Hk*Wk), 64 output channels x cib input channels per box
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(Co),
                                static_cast<cuuint64_t>(wCi),
                                static_cast<cuuint64_t>(nwin)};
  const cuuint64_t w_strides[2] = {2ull * Co, 2ull * Co * wCi};
  const cuuint32_t w_box[3] = {64, static_cast<cuuint32_t>(cib), 1};
  CUtensorMap mx, mw;
  int err = make_map(&mx, x, 4, x_dims, x_strides, x_box,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  err = make_map(&mw, w, 3, w_dims, w_strides, w_box,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bn == 64)
    e = launch_k<64>(cib, mx, mw, bias, res, out, g, smem_bytes, s);
  else if (bn == 128)
    e = launch_k<128>(cib, mx, mw, bias, res, out, g, smem_bytes, s);
  else if (bn == 256)
    e = launch_k<256>(cib, mx, mw, bias, res, out, g, smem_bytes, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* conv_lb_sm90_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
