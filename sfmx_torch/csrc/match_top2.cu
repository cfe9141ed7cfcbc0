// K4 match_top2: streaming top-2 of a bf16 descriptor GEMM for Hopper.
//
// Replaces the TPU kernel sfmx/kernels/pallas_match.py match_top2
// (_match_kernel).  For every query row a, over all landmark rows b:
//   s1 = max_b bf16(a).bf16(b) accumulated in f32, i1 = its lowest argmax,
//   s2 = the largest score of any column other than i1 (== s1 on a tie).
// The (Ka,Kb) similarity matrix never exists.
//
// What bounds it on the H100: operations.  At the serving shape (32 queries
// x 1024 keypoints against >= 131,072 landmarks, D = 128) one call is
// ~1.1 TFLOP and reads only ~8 MB of queries and ~34 MB of landmarks (the
// pool stays in the 50 MB L2), so the tensor cores are the limit, and only
// `wgmma` reaches their full rate.  Three things kept an `mma.sync` kernel
// at a quarter of it, and the design answers each:
//   * Products.  A block is two consumer warpgroups and one producer.  Each
//     consumer owns 64 query rows for the whole call and keeps them as
//     `wgmma` A fragments in registers (32 registers a thread), so a product
//     reads only the landmark tile from shared memory.  The producer's one
//     thread keeps TMA loads of landmark tiles (BN rows x 128 bf16, as two
//     boxes of 64 columns in the 128-byte swizzle that `wgmma` reads) in
//     flight into a ring of stages, each with a full and an empty
//     `mbarrier`; nobody else spends an instruction on a copy.
//   * The top-2 bookkeeping.  A consumer holds two accumulator sets: while
//     the `wgmma`s of tile j+1 run, it folds tile j into the running (best,
//     argbest, second) of its rows.  A score can change a row's state only
//     if it exceeds the running second, so a thread first takes the maximum
//     of its values of a row (one instruction a score) and walks the tile,
//     in increasing column order with the strict '>', only when that
//     maximum exceeds its second.  After the first tiles that is rare, and
//     the result is the unfiltered fold's bit for bit, ties included.
//   * Few query rows.  The TPU kernel carried the running top-2 through a
//     sequential grid; GPU blocks run in no order, so a block owns its 128
//     rows and nothing carries between row blocks.  Where the row blocks do
//     not fill the card, the grid's second dimension splits the landmark
//     loop into contiguous, tile-aligned ranges; each block writes its
//     partial (s1, i1, s2) to a scratch of splits x Ka and a second, small
//     launch merges a row's partials in split order: take on strictly
//     greater, second = max of the loser's best and both seconds.  No
//     atomics, so the result does not depend on the order in which blocks
//     run and equals the unsplit kernel's.
// Scores come from bf16 `wgmma` m64nBNk16 with f32 accumulation (the
// products of bf16 values are exact in f32, so only the summation order
// differs from the plain version).  At the end the 4 threads that share a
// row merge with shuffles, ties to the lower index.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                 // descriptor width (the wrapper zero-pads up to it)
constexpr int WG_ROWS = 64;            // query rows of one consumer warpgroup: one wgmma m64
constexpr int CONSUMERS = 2;           // consumer warpgroups per block
constexpr int BM = WG_ROWS * CONSUMERS;
constexpr int THREADS = (CONSUMERS + 1) * 128;   // the last warpgroup is the producer
constexpr int KSTEPS = D / 16;         // wgmma k-steps per row
constexpr int BOX_K = 64;              // bf16 columns of a TMA box: the swizzle's 128 bytes
constexpr int BN_DEFAULT = 128;        // landmark rows per tile
constexpr int STAGES_DEFAULT = 3;      // tiles in the shared-memory ring
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;       // bytes of shared memory a block may use
constexpr float NEG = -1e30f;          // the reference's running-max init

constexpr int ERR_NO_ENCODER = -1;     // cuTensorMapEncodeTiled not found in libcuda
constexpr int ERR_ENCODE = -2;         // cuTensorMapEncodeTiled refused the map

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase of the given parity has completed.  Built
// with -DMT_SPIN_LIMIT=<clock cycles>, a wait that lasts longer traps instead
// of hanging the card: for the first runs of a changed pipeline.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#ifdef MT_SPIN_LIMIT
  const long long t0 = clock64();
#endif
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
#ifdef MT_SPIN_LIMIT
    if (!done && clock64() - t0 > MT_SPIN_LIMIT) __trap();
#endif
  } while (!done);
}
// One box of the pool's tensor map into shared memory; completion goes to `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

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

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d, i) ACC4(d, i), ACC4(d, i + 4), ACC4(d, i + 8), ACC4(d, i + 12)

// d (64 x N, f32 in registers) = or += a (64 x 16 bf16, register fragments)
// times the N x 16 K-major tile behind `desc`.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : ACC16(d, 0), ACC16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : ACC16(d, 0), ACC16(d, 16), ACC16(d, 32), ACC16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The compiler does not know that `wgmma` writes its accumulators later than
// it starts: tie every register to this point in the instruction order.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// All k-steps of one landmark tile (at shared address `tile`) into `acc`, as
// one wgmma group.
template <int BN>
__device__ __forceinline__ void multiply_tile(float (&acc)[BN / 2], const uint32_t (&a)[KSTEPS][4],
                                           uint32_t tile) {
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    // columns 0..63 in the first box, 64..127 in the second; a k-step is
    // 32 bytes further inside the swizzled row
    const uint32_t at = tile + (ks / 4) * (BN * BOX_K * 2) + (ks % 4) * 32;
    wgmma_rs(acc, a[ks], smem_desc(at), ks > 0);
  }
  wgmma_commit();
}

// Fold score s of column j into a running top-2 whose columns all precede j.
__device__ __forceinline__ void fold(float s, int j, float& b1, float& b2, int& i1) {
  const bool gt = s > b1;
  b2 = gt ? b1 : fmaxf(b2, s);
  i1 = gt ? j : i1;
  b1 = gt ? s : b1;
}

// One tile's accumulators into the thread's two rows.  Accumulator layout:
// acc[4i], acc[4i+1] = row g, columns 8i + 2t, + 1; acc[4i+2], acc[4i+3] =
// row g + 8.  `col` is the tile's first column + 2t.  A row's values enter
// the fold only if their maximum exceeds the row's running second: nothing
// else could change (best, argbest, second).
template <int BN>
__device__ __forceinline__ void fold_tile(const float (&acc)[BN / 2], int col, float (&b1)[2],
                                          float (&b2)[2], int (&i1)[2]) {
  float m0 = fmaxf(acc[0], acc[1]), m1 = fmaxf(acc[2], acc[3]);
#pragma unroll
  for (int i = 1; i < BN / 8; ++i) {
    m0 = fmaxf(m0, fmaxf(acc[4 * i], acc[4 * i + 1]));
    m1 = fmaxf(m1, fmaxf(acc[4 * i + 2], acc[4 * i + 3]));
  }
  if (m0 > b2[0]) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      fold(acc[4 * i], col + 8 * i, b1[0], b2[0], i1[0]);
      fold(acc[4 * i + 1], col + 8 * i + 1, b1[0], b2[0], i1[0]);
    }
  }
  if (m1 > b2[1]) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      fold(acc[4 * i + 2], col + 8 * i, b1[1], b2[1], i1[1]);
      fold(acc[4 * i + 3], col + 8 * i + 1, b1[1], b2[1], i1[1]);
    }
  }
}

// A consumer's view of the ring of landmark tiles: the shared addresses of
// the tiles and of the two barrier arrays, the next stage to multiply from (with
// the parity its full barrier will show) and the next stage to hand back.
struct Ring {
  uint32_t tiles, full, empty;
  int stages, in_stage, out_stage;
  uint32_t in_phase;
};

// Wait for the next tile of the ring and start its products into `acc`.
template <int BN>
__device__ __forceinline__ void start_tile(Ring& r, float (&acc)[BN / 2],
                                      const uint32_t (&a)[KSTEPS][4]) {
  mbar_wait(r.full + 8 * r.in_stage, r.in_phase);
  multiply_tile<BN>(acc, a, r.tiles + r.in_stage * (BN * D * 2));
  if (++r.in_stage == r.stages) {
    r.in_stage = 0;
    r.in_phase ^= 1;
  }
}

// The oldest tile's products are done (the caller waited for its group):
// every warp hands the stage back, then folds the tile into its rows.
template <int BN>
__device__ __forceinline__ void retire(Ring& r, float (&acc)[BN / 2], int col, int lane,
                                       float (&b1)[2], float (&b2)[2], int (&i1)[2]) {
  pin(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(r.empty + 8 * r.out_stage);
  if (++r.out_stage == r.stages) r.out_stage = 0;
  fold_tile<BN>(acc, col, b1, b2, i1);
}

// Merge (o1, oi, o2) into (x1, xi, x2): two top-2 states over disjoint
// columns.  Ties go to the lower index; the second is the larger of the
// loser's best and both seconds.
__device__ __forceinline__ void merge(float& x1, int& xi, float& x2, float o1, int oi, float o2) {
  const bool take = o1 > x1 || (o1 == x1 && oi < xi);
  x2 = fmaxf(fminf(x1, o1), fmaxf(x2, o2));
  xi = take ? oi : xi;
  x1 = take ? o1 : x1;
}

// Block (blockIdx.x, blockIdx.y): query rows blockIdx.x * BM .. + BM against
// the landmark tiles [blockIdx.y * tiles_per_split, ... + tiles_per_split)
// clipped to `tiles`.  Writes row r's top-2 to index blockIdx.y * Ka + r of
// the outputs: the results themselves with one split, the scratch otherwise.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
match_top2_kernel(__grid_constant__ const CUtensorMap pool_map,
                  const __nv_bfloat16* __restrict__ A, int Ka, int tiles, int tiles_per_split,
                  int stages, float* __restrict__ s1_out, int* __restrict__ i1_out,
                  float* __restrict__ s2_out) {
  extern __shared__ uint8_t ring_raw[];
  __shared__ uint64_t full_bar[MAX_STAGES], empty_bar[MAX_STAGES];
  constexpr uint32_t STAGE_BYTES = BN * D * 2;
  const uint32_t ring = (smem_u32(ring_raw) + 1023u) & ~1023u;   // the swizzle's alignment
  const int t_begin = blockIdx.y * tiles_per_split;
  const int n = min(tiles_per_split, tiles - t_begin);           // >= 1: the host checks

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);                  // the producer's expect_tx
      mbar_init(smem_u32(&empty_bar[s]), CONSUMERS * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 1;          // a fresh ring is empty: the first waits pass
      for (int t = 0; t < n; ++t) {
        const uint32_t full = smem_u32(&full_bar[stage]);
        mbar_wait(smem_u32(&empty_bar[stage]), phase);
        mbar_expect_tx(full, STAGE_BYTES);
        const uint32_t dst = ring + stage * STAGE_BYTES;
        const int row = (t_begin + t) * BN;
        tma_load_2d(dst, &pool_map, full, 0, row);
        tma_load_2d(dst + BN * BOX_K * 2, &pool_map, full, BOX_K, row);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, two accumulator sets ---------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * BM + wg * WG_ROWS + warp * 16;

    // A fragments of wgmma m64k16 (warp w holds rows 16w..16w+15): reg0 = row
    // g, k 2t..2t+1; reg1 = row g+8; reg2/reg3 the same at k+8.  Rows past
    // Ka read as zero and are never written.
    uint32_t a[KSTEPS][4];
    {
      const int ra = row0 + g, rb = ra + 8;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int k = ks * 16 + 2 * t;
        const uint32_t* pa = reinterpret_cast<const uint32_t*>(A + (size_t)ra * D + k);
        const uint32_t* pb = reinterpret_cast<const uint32_t*>(A + (size_t)rb * D + k);
        a[ks][0] = ra < Ka ? pa[0] : 0u;
        a[ks][1] = rb < Ka ? pb[0] : 0u;
        a[ks][2] = ra < Ka ? pa[4] : 0u;
        a[ks][3] = rb < Ka ? pb[4] : 0u;
      }
    }

    float b1[2] = {NEG, NEG}, b2[2] = {NEG, NEG};
    int i1[2] = {0, 0};
    float acc0[BN / 2], acc1[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.0f;

    Ring rs{ring, smem_u32(full_bar), smem_u32(empty_bar), stages, 0, 0, 0u};
    const int col0 = t_begin * BN + 2 * t;   // this thread's first column
    start_tile<BN>(rs, acc0, a);
    int j = 0;
    for (; j + 2 < n; j += 2) {    // tile j is in flight in acc0; j+1 and j+2 exist
      start_tile<BN>(rs, acc1, a);
      wgmma_wait<1>();
      retire<BN>(rs, acc0, col0 + j * BN, lane, b1, b2, i1);
      start_tile<BN>(rs, acc0, a);
      wgmma_wait<1>();
      retire<BN>(rs, acc1, col0 + (j + 1) * BN, lane, b1, b2, i1);
    }
    if (j + 1 < n) {
      start_tile<BN>(rs, acc1, a);
      wgmma_wait<1>();
      retire<BN>(rs, acc0, col0 + j * BN, lane, b1, b2, i1);
      wgmma_wait<0>();
      retire<BN>(rs, acc1, col0 + (j + 1) * BN, lane, b1, b2, i1);
    } else {
      wgmma_wait<0>();
      retire<BN>(rs, acc0, col0 + j * BN, lane, b1, b2, i1);
    }

    // merge the 4 threads of a quad (same rows, disjoint columns)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x1 = b1[h], x2 = b2[h];
      int xi = i1[h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float o1 = __shfl_xor_sync(0xffffffffu, x1, off);
        const float o2 = __shfl_xor_sync(0xffffffffu, x2, off);
        const int oi = __shfl_xor_sync(0xffffffffu, xi, off);
        merge(x1, xi, x2, o1, oi, o2);
      }
      const int r = row0 + g + 8 * h;
      if (t == 0 && r < Ka) {
        const size_t at = (size_t)blockIdx.y * Ka + r;
        s1_out[at] = x1;
        i1_out[at] = xi;
        s2_out[at] = x2;
      }
    }
  }
}

// A row's partials of all splits, in split order, into its result.
__global__ void merge_splits_kernel(const float* __restrict__ ps1, const int* __restrict__ pi1,
                                    const float* __restrict__ ps2, int Ka, int splits,
                                    float* __restrict__ s1, int* __restrict__ i1,
                                    float* __restrict__ s2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Ka) return;
  float x1 = ps1[r], x2 = ps2[r];
  int xi = pi1[r];
  for (int s = 1; s < splits; ++s) {
    const size_t at = (size_t)s * Ka + r;
    merge(x1, xi, x2, ps1[at], pi1[at], ps2[at]);
  }
  s1[r] = x1;
  i1[r] = xi;
  s2[r] = x2;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled belongs to libcuda, not to the runtime: taken from
// the copy of it the process has already loaded, so the build links nothing
// more.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libcuda.so", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

template <int BN>
int launch(const CUtensorMap& map, const __nv_bfloat16* A, int Ka, int tiles, int splits,
           int stages, float* o1, int* oi, float* o2, cudaStream_t stream) {
  const int smem = stages * BN * D * 2 + 1024;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(match_top2_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ka + BM - 1) / BM, splits);
  match_top2_kernel<BN><<<grid, THREADS, smem, stream>>>(
      map, A, Ka, tiles, (tiles + splits - 1) / splits, stages, o1, oi, o2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A (Ka,128) bf16, B (Kb,128) bf16, both contiguous; Kb % bn == 0, bn 64 or
// 128 landmark rows per tile, `stages` tiles in the ring.  Writes s1 (Ka,)
// f32, i1 (Ka,) i32, s2 (Ka,) f32 on the given stream.  `splits` > 1 cuts the
// landmark tiles into that many contiguous ranges of ceil(tiles / splits)
// (none may be empty), each written to the scratch ps1, pi1, ps2 (splits x Ka
// each), and a second launch merges them.  Returns cudaGetLastError() after
// the last launch, cudaErrorInvalidValue, or a negative code where the
// tensor map could not be encoded (see mt_error_string).
int mt_match_top2(const void* A, const void* B, int Ka, int Kb, float* s1, int* i1, float* s2,
                  float* ps1, int* pi1, float* ps2, int splits, int bn, int stages,
                  void* stream) {
  if (Ka < 0 || Kb <= 0 || (bn != 64 && bn != 128) || Kb % bn != 0 || stages < 2 ||
      stages > MAX_STAGES || splits < 1)
    return cudaErrorInvalidValue;
  const int tiles = Kb / bn;
  const int per = (tiles + splits - 1) / splits;
  if ((splits - 1) * per >= tiles) return cudaErrorInvalidValue;
  if (splits > 1 && (!ps1 || !pi1 || !ps2)) return cudaErrorInvalidValue;
  if (Ka == 0) return cudaSuccess;

  const EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)Kb};        // innermost first
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};                 // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)BOX_K, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(B), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
  float* o1 = splits > 1 ? ps1 : s1;
  int* oi = splits > 1 ? pi1 : i1;
  float* o2 = splits > 1 ? ps2 : s2;
  int err = bn == 64 ? launch<64>(map, a, Ka, tiles, splits, stages, o1, oi, o2, st)
                     : launch<128>(map, a, Ka, tiles, splits, stages, o1, oi, o2, st);
  if (err != cudaSuccess || splits == 1) return err;
  merge_splits_kernel<<<(Ka + 255) / 256, 256, 0, st>>>(ps1, pi1, ps2, Ka, splits, s1, i1, s2);
  return cudaGetLastError();
}

const char* mt_error_string(int err) {
  if (err == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in libcuda";
  if (err == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the landmark pool's tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mt_tile_rows() { return BN_DEFAULT; }
int mt_stages() { return STAGES_DEFAULT; }
int mt_block_rows() { return BM; }

}  // extern "C"
