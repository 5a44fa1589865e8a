// Psum-stationary matmul (M, K) @ (K, N) -> (M, N) in bf16 on
// Hopper's tensor cores (sm_90a): bf16 in, f32 sums, bf16 out.
//
// Replaces, with csrc/matmul_lb.cu (which keeps f32 and the layouts TMA
// cannot describe), the TPU kernel `_matmul_kernel` launched by
// `matmul_lb_call` (src/repro/kernels/matmul_lb/kernel.py:23, :36).
// That kernel keeps a (bm, bn) f32 accumulator resident over the K
// sweep and writes each output word once in the input's type; this one
// computes the same function, designed for this card.
//
// What bounds it on this card.  At the repo's shapes (thousands of
// rows, columns and reduction steps) the work is 2*M*N*K operations
// against (M*K + K*N + M*N) 2-byte words: over a thousand operations
// per byte, above the card's bf16 balance (989 TFLOP/s over
// 3.35 TB/s, about 295 per byte), so the tensor-core rate bounds it.
//
// What the design does about it.
//  * Only wgmma reaches the tensor-core rate: each CTA owns a 128 x BN
//    (BN 128 or 256) output tile, two consumer warpgroups of 64 rows
//    each, and runs wgmma.mma_async m64nBNk16 with both operands read
//    from shared memory.  The f32 sums stay in registers over the
//    whole K sweep (the reference's resident accumulator block): BN/2
//    a thread.
//  * The operands arrive by TMA, issued by one producer thread, into a
//    ring of kStages stages of A 128x64 and B 64xBN bf16 tiles laid
//    out with the 128-byte swizzle that wgmma reads without bank
//    conflicts.  Each stage has a "full" mbarrier (the TMA's
//    transaction bytes) and an "empty" one (one arrival per consumer
//    warp); a consumer releases a stage only after the wgmma group
//    that read it has retired, with one group left in flight so the
//    tensor cores never wait for the release.
//  * The producer warpgroup gives its registers to the consumers
//    (setmaxnreg).
//  * Both B layouts, one template flag: a K-major w (w.t() of a
//    contiguous (N, K)) is read like A; an N-major w (a contiguous
//    (K, N)) arrives as 64 x 64 boxes and is read with wgmma's
//    transpose-B bit, so neither is copied.
//  * Ragged edges cost nothing in the main loop: TMA zero-fills rows,
//    columns and K beyond the tensor.  The epilogue rounds to bf16
//    (nearest even) and stores only inside M x N.
//  * Bytes: a wave of 132 CTAs in row-major order would span one or
//    two row tiles and every column tile, so B would come from device
//    memory again for every pair of row tiles.  The CTAs run in groups
//    of kGroupM row tiles, row tile fastest: a wave then touches about
//    16 A tiles and 8 B tiles (about 40 MB at K 5120), which L2 holds.
//  * No persistence, no clusters, no TMA store yet.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output rows per CTA
constexpr int kBK = 64;         // K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;   // warpgroups of 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 16;     // row tiles a raster group sweeps first

template <int BN>
struct Smem {
  static constexpr int kA = kBM * kBK * 2;         // bytes of one A tile
  static constexpr int kB = BN * kBK * 2;          // bytes of one B tile
  static constexpr int kStage = kA + kB;
  // 1024 bytes of slack to align the ring to the swizzle's period
  static constexpr int kBytes = kStages * kStage + 2 * kStages * 8 + 1024;
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

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
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

// d (64 x n f32 fragment) += A (64 x 16, K-major) B (16 x n); TB = 1
// reads B MN-major (transpose-B)
template <int TB>
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
      "%64, %65, p, 1, 1, 0, %67;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
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
      "%128, %129, p, 1, 1, 0, %131;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}


template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128)
    wgmma_n128<TB>(d, da, db);
  else
    wgmma_n256<TB>(d, da, db);
}

__device__ __forceinline__ void store2(__nv_bfloat16* c, int row, int col,
                                       float v0, float v1, int M, int N,
                                       int pairs) {
  if (row >= M) return;
  __nv_bfloat16* p = c + static_cast<size_t>(row) * N + col;
  if (pairs && col + 1 < N) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < N) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
  }
}

// KMAJOR_B: w is K-major ((N, K) rows of K in memory) rather than
// N-major ((K, N) rows of N)
template <int BN, bool KMAJOR_B>
__global__ void __launch_bounds__(kThreads, 1)
matmul_lb_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  using S = Smem<BN>;
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + kStages * S::kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int wg = threadIdx.x / 128;
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
      mbar_init(empty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        // the first pass finds every stage empty (parity of the phase
        // before the first)
        mbar_wait(empty(s), phase ^ 1);
        const uint32_t a_dst = ring + s * S::kStage;
        const uint32_t b_dst = a_dst + S::kA;
        mbar_expect_tx(full(s), S::kStage);
        const int k0 = kt * kBK;
        tma_load(a_dst, &map_a, full(s), k0, m0);
        if constexpr (KMAJOR_B) {
          tma_load(b_dst, &map_b, full(s), k0, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(b_dst + j * 64 * kBK * 2, &map_b, full(s), n0 + 64 * j,
                     k0);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;   // this consumer's 64 rows: 64*cw ..
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full(s), phase);
      const uint32_t a_tile = ring + s * S::kStage + cw * 64 * kBK * 2;
      const uint32_t b_tile = ring + s * S::kStage + S::kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: rows of 128 bytes, 8-row groups 1024 bytes apart; a k16
        // step is 32 bytes along the swizzled row
        const uint64_t da = gmma_desc(a_tile + kk * 32, 16, 1024);
        uint64_t db;
        if constexpr (KMAJOR_B)
          db = gmma_desc(b_tile + kk * 32, 16, 1024);
        else
          // B MN-major: 64-column boxes 8 KB apart (leading), 8-row
          // K groups 1024 bytes apart (stride); a k16 step is 16 rows
          db = gmma_desc(b_tile + kk * 2048, 64 * kBK * 2, 1024);
        wgmma_tile<BN, KMAJOR_B ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      if (kt > 0) {
        // the group of the previous stage has retired: release it
        wgmma_wait<1>();
        if (threadIdx.x % 32 == 0) mbar_arrive(empty(prev));
      }
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();

    // thread t of warp w holds rows 16w + t/4 (+8) and columns
    // 8j + 2(t%4) (+1) of its 64 x BN fragment
    const int t = threadIdx.x % 128;
    const int row = m0 + cw * 64 + 16 * (t / 32) + (t % 32) / 4;
    const int col = n0 + 2 * (t % 4);
    const int pairs = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      store2(c, row, col + 8 * j, acc[4 * j], acc[4 * j + 1], M, N, pairs);
      store2(c, row + 8, col + 8 * j, acc[4 * j + 2], acc[4 * j + 3], M, N,
             pairs);
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

// a 2-D bf16 map: `inner` x `outer` elements, rows `pitch` elements
// apart, boxes of box_inner x box_outer, 128-byte swizzle, zero fill
int make_map(CUtensorMap* map, const void* base, uint64_t inner,
             uint64_t outer, uint64_t pitch, uint32_t box_inner,
             uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int BN, bool KMAJOR_B>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, void* c,
                   int M, int N, int K, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_lb_sm90_kernel<BN, KMAJOR_B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BN>::kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int grid = ((N + BN - 1) / BN) * ((M + kBM - 1) / kBM);
  matmul_lb_sm90_kernel<BN, KMAJOR_B>
      <<<grid, kThreads, Smem<BN>::kBytes, stream>>>(
          ma, mb, static_cast<__nv_bfloat16*>(c), M, N, K);
  return cudaGetLastError();
}

static_assert(Smem<256>::kBytes <= 232448, "ring exceeds shared memory");

}  // namespace

// a: (M, K) rows lda elements apart; b: w as (K, N) rows ldb apart
// (b_kmajor 0) or as (N, K) rows ldb apart (b_kmajor 1); c: contiguous
// (M, N).  Bases 16-byte aligned, pitches multiples of 8 elements (the
// wrapper's route checks both).  Returns a CUDA error code, or 1000 +
// the CUresult of a refused tensor map, or -1 if the driver has no
// cuTensorMapEncodeTiled.
extern "C" int matmul_lb_sm90_forward(const void* a, const void* b, void* c,
                                      int M, int N, int K, int lda, int ldb,
                                      int bn, int b_kmajor, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (bn != 128 && bn != 256) ||
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + bn - 1) / bn) >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  int err = make_map(&ma, a, K, M, lda, kBK, kBM);
  if (err) return err;
  if (b_kmajor)
    err = make_map(&mb, b, K, N, ldb, kBK, bn);
  else
    err = make_map(&mb, b, N, K, ldb, 64, kBK);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bn == 128)
    e = b_kmajor ? launch<128, true>(ma, mb, c, M, N, K, s)
                 : launch<128, false>(ma, mb, c, M, N, K, s);
  else
    e = b_kmajor ? launch<256, true>(ma, mb, c, M, N, K, s)
                 : launch<256, false>(ma, mb, c, M, N, K, s);
  return static_cast<int>(e);
}

extern "C" const char* matmul_lb_sm90_error_string(int err) {
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= 1000) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
