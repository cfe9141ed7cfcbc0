// K5 match_pairs_fused, its raw mode K10 match_pairs_top2, and K9
// match_pairs_tiled: per-pair brute-force descriptor matching for Hopper.
//
// Replaces the TPU kernels
//   sfmx/kernels/pallas_pairs.py  match_pairs_float_pallas (_pairs_fused_kernel)  K5
//   sfmx/kernels/pallas_pairs.py  match_pairs_top2 (_pairs_kernel)               K10
//   sfmx/kernels/pallas_tiles.py  match_pairs_float_tiled (_tiles_kernel)         K9
// For a listed image pair (a, b) with K keypoint slots each, over the (K,K)
// similarity bf16(a).bf16(b) accumulated in f32:
//   - per a-row: s1 = best over b-columns (masked columns score NEG), i1 its
//     lowest index, s2 = the best of the other columns (== s1 on a tie);
//   - per b-column: j1, the best a-row among unmasked rows, lowest row on a
//     tie;
//   - finish: the Lowe ratio test on d = 2 - 2s, the masks, and the mutual
//     check "the column's best row of i1 is this row" (the dense matcher's
//     index cross-check, sfmx/kernels/matching.py:match_similarity).  Masked
//     a-rows get score NEG and index 0, as the dense matcher gives them.
// The raw mode (K10) has no masks and no tests: it returns s1, i1, s2 and j1.
// The (K,K) matrix never leaves the SM.
//
// What bounds it on the H100: operations.  At the cli default (K = 1024,
// D = 128) a pair is 0.27 GFLOP against 0.5 MB of descriptors, which stay in
// the 50 MB L2 across the pairs that share an image, so the bf16 tensor
// cores are the limit, and only `wgmma` reaches their full rate.  The design
// takes match_top2.cu's pipeline (K4) and answers the column's best row
// without any per-score bookkeeping:
//   * Products.  A block is two consumer warpgroups of 64 a-rows each, which
//     hold their rows as `wgmma` A fragments in registers, and one producer
//     thread that keeps TMA loads of 128-row b-tiles (two 64-column boxes in
//     the 128-byte swizzle over the descriptors viewed as (C*K, 128) bf16) in
//     flight into a ring of stages with full and empty `mbarrier`s.
//   * A block owns 128 rows of ONE row image and a GROUP of listed pairs that
//     share it (the wrapper sorts the list by row image and cuts each image's
//     pairs into groups of at most `pairs_per_block`; K9 passes its tile
//     packing's groups).  Its A fragments load once for the group's whole
//     stream of tiles, and the pipeline's start and end are paid once per
//     group.  The running top-2 is reset per pair, and a pair's arithmetic
//     (the k-order of the `wgmma`, the order of its tiles) does not depend on
//     its group, so K9 equals K5 in every field.
//   * Column masks ride beside each tile as a bias row (0 or NEG, one f32 per
//     column, from a (C, Kp) table padded with NEG to a tile multiple) and a
//     flag "the tile has a masked column", loaded by a bulk copy on the same
//     barrier.  A flagged tile's accumulators start from the bias, so the
//     `wgmma` adds it (NEG + s rounds to NEG exactly, 0 + s is s); the others
//     start from zero as usual.  The bias also masks the columns of a tile
//     that runs past the image's K rows into the next image (or past the
//     tensor, where TMA fills zeros).
//   * Row top-2 by a fold in increasing column order with the strict '>', so
//     the lowest index keeps a tie.  A pair streams only K/128 tiles, so the
//     running second is low for most of them: K4's filter would let nearly
//     every warp walk anyway, and the fold is the kernel's limit (issue
//     slots, not the tensor cores): each score costs its fold and little
//     else, 5 instructions for the top-2, 3 for the swapped list's top-1.
//   * The column's best row: the best row of column j of pair (a, b) under
//     a's row mask, lowest row first, IS the best column of row j of the
//     swapped pair (b, a) under a's column mask, lowest index first.  So the
//     same body runs the swapped list too (its groups sorted by b), in the
//     same launch (the grid's later blocks), and writes its i1 as the pair's
//     j1.  That doubles the products but leaves no column reduction, no
//     atomics and no scratch to clear, the tie rule is the row fold's own,
//     and K10's raw j1 comes out directly.  (The TPU kernel compared values,
//     bmax[i1] == s1, which accepts both of two exactly tied rows.)
// A second small launch (finish_kernel) applies the tests in match mode; the
// raw mode needs none.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                 // descriptor width (the wrapper zero-pads up to it)
constexpr int WG_ROWS = 64;            // rows of one consumer warpgroup: one wgmma m64
constexpr int CONSUMERS = 2;           // consumer warpgroups per block
constexpr int BM = WG_ROWS * CONSUMERS;
constexpr int THREADS = (CONSUMERS + 1) * 128;   // the last warpgroup is the producer
constexpr int KSTEPS = D / 16;         // wgmma k-steps per row
constexpr int BOX_K = 64;              // bf16 columns of a TMA box: the swizzle's 128 bytes
constexpr int BN = 128;                // b-rows (columns of the score tile) per tile
constexpr int TILE_BYTES = BN * D * 2;
constexpr int BIAS_ROW = BN + 4;       // a tile's column bias, then its "any column masked" flag
constexpr int BIAS_BYTES = BIAS_ROW * 4;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;       // bytes of shared memory a block may use
constexpr float NEG = -1e30f;          // the dense matcher's masked score

constexpr int ERR_NO_ENCODER = -1;     // cuTensorMapEncodeTiled not found in libcuda
constexpr int ERR_ENCODE = -2;         // cuTensorMapEncodeTiled refused the map

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier, TMA and bulk copies -----------------------------------------

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
// with -DMP_SPIN_LIMIT=<clock cycles>, a wait that lasts longer traps instead
// of hanging the card: for the first runs of a changed pipeline.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#ifdef MP_SPIN_LIMIT
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
#ifdef MP_SPIN_LIMIT
    if (!done && clock64() - t0 > MP_SPIN_LIMIT) __trap();
#endif
  } while (!done);
}
// One box of the descriptors' tensor map into shared memory; completion goes to `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global memory
// into shared memory; completion goes to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
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

// d (64 x 128, f32 in registers) = or += a (64 x 16 bf16, register
// fragments) times the 128 x 16 K-major tile behind `desc`.
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

// All k-steps of one b-tile (at shared address `tile`) into `acc`, as one
// wgmma group: the same k-order for every tile of every pair.  With `onto`
// the products add onto acc's values (the column bias), else the first
// k-step overwrites them.
__device__ __forceinline__ void multiply_tile(float (&acc)[BN / 2], const uint32_t (&a)[KSTEPS][4],
                                           uint32_t tile, bool onto) {
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    // columns 0..63 in the first box, 64..127 in the second; a k-step is
    // 32 bytes further inside the swizzled row
    const uint32_t at = tile + (ks / 4) * (BN * BOX_K * 2) + (ks % 4) * 32;
    wgmma_rs(acc, a[ks], smem_desc(at), ks > 0 || onto);
  }
  wgmma_commit();
}

// Fold score s of column j into a running top-2 (TOP2) or top-1 whose
// columns all precede j: the strict '>' keeps the lowest index on a tie, and
// the second is max(second, min(best, s)), which is s == best on a tie.
template <bool TOP2>
__device__ __forceinline__ void fold(float s, int j, float& b1, float& b2, int& i1) {
  if (TOP2) b2 = fmaxf(b2, fminf(b1, s));
  i1 = s > b1 ? j : i1;
  b1 = fmaxf(b1, s);
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

// The running state of a thread's two rows (g and g + 8 of its warp's 16).
struct Rows {
  float b1[2], b2[2];
  int i1[2];
  __device__ __forceinline__ void reset() {
    b1[0] = b1[1] = b2[0] = b2[1] = NEG;
    i1[0] = i1[1] = 0;
  }
};

// One tile's accumulators into the thread's two rows, each in increasing
// column order.  Accumulator layout: acc[4i], acc[4i+1] = row g, columns
// 8i + 2t, + 1; acc[4i+2], acc[4i+3] = row g + 8.  `col` is the tile's
// first column + 2t.  Every value is folded: a pair's stream is only K/128
// tiles, and K4's filter (walk a row only when the tile's maximum exceeds
// its running second) let nearly every warp walk in most tiles, so it cost
// its maximum on top of the walk.
template <bool TOP2>
__device__ __forceinline__ void fold_tile(const float (&acc)[BN / 2], int col, Rows& st) {
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    fold<TOP2>(acc[4 * i], col + 8 * i, st.b1[0], st.b2[0], st.i1[0]);
    fold<TOP2>(acc[4 * i + 2], col + 8 * i, st.b1[1], st.b2[1], st.i1[1]);
    fold<TOP2>(acc[4 * i + 1], col + 8 * i + 1, st.b1[0], st.b2[0], st.i1[0]);
    fold<TOP2>(acc[4 * i + 3], col + 8 * i + 1, st.b1[1], st.b2[1], st.i1[1]);
  }
}

// One direction of the work: a list of (row image, column image) pairs in
// processing order, cut into groups that share their row image.  Outputs are
// (n_out, K) at row out_row[n]; s1 and s2 may be null (the swapped list writes
// only its i1, which is the listed pair's j1).
struct Dir {
  const int* pairs;         // (N, 2)
  const int* out_row;       // (N,)
  const int* group_start;   // (G + 1,)
  int n_groups;
  float* s1;
  int* i1;
  float* s2;
};

// A consumer's view of the ring: the shared addresses of the tiles, the bias
// rows and the two barrier arrays, the next stage to multiply from (with the
// parity its full barrier will show) and the next stage to hand back; and the
// pair and tile of the next tile to retire.
struct Ring {
  uint32_t tiles, full, empty;
  const float* bias;
  int stages, in_stage, out_stage;
  uint32_t in_phase;
  int pair, tile;
};

// Wait for the next tile of the ring and start its products into `acc`.
// Where the tile has a masked column, the accumulators start from the
// column bias (0 or NEG), so masked scores come out NEG: 0 + s is s and
// NEG + s rounds to NEG.  `t` is the thread's lane & 3.
__device__ __forceinline__ void start_tile(Ring& r, float (&acc)[BN / 2],
                                           const uint32_t (&a)[KSTEPS][4], int t) {
  mbar_wait(r.full + 8 * r.in_stage, r.in_phase);
  const float* bias = r.bias + r.in_stage * BIAS_ROW;
  const bool masked = bias[BN] != 0.0f;
  if (masked) {
    const float2* b2 = reinterpret_cast<const float2*>(bias);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 b = b2[4 * i + t];     // columns 8i + 2t, + 1
      acc[4 * i] = b.x;
      acc[4 * i + 1] = b.y;
      acc[4 * i + 2] = b.x;
      acc[4 * i + 3] = b.y;
    }
  }
  multiply_tile(acc, a, r.tiles + r.in_stage * TILE_BYTES, masked);
  if (++r.in_stage == r.stages) {
    r.in_stage = 0;
    r.in_phase ^= 1;
  }
}

// The 4 threads of a quad hold disjoint columns of the same two rows: merge
// them and write the pair's rows, then start the next pair afresh.
__device__ __forceinline__ void emit(Rows& st, const Dir& dir, int n, int row0, int g, int t,
                                     int K) {
  const size_t o = (size_t)dir.out_row[n] * K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x1 = st.b1[h], x2 = st.b2[h];
    int xi = st.i1[h];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, x1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, x2, off);     // NEG for a top-1
      const int oi = __shfl_xor_sync(0xffffffffu, xi, off);
      merge(x1, xi, x2, o1, oi, o2);
    }
    const int r = row0 + g + 8 * h;
    if (t == 0 && r < K) {
      if (dir.s1 != nullptr) dir.s1[o + r] = x1;
      dir.i1[o + r] = xi;
      if (dir.s2 != nullptr) dir.s2[o + r] = x2;
    }
  }
  st.reset();
}

// The oldest tile's products are done (the caller waited for its group):
// every warp hands the stage back, the tile is folded into the rows (the
// listed pairs keep a top-2, the swapped list a top-1), and the pair's rows
// go out after its last tile.
__device__ __forceinline__ void retire(Ring& r, float (&acc)[BN / 2], Rows& st, const Dir& dir,
                                       bool top2, int first, int ntiles, int row0, int lane,
                                       int K) {
  const int g = lane >> 2, t = lane & 3;
  pin(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(r.empty + 8 * r.out_stage);
  if (++r.out_stage == r.stages) r.out_stage = 0;
  if (top2)
    fold_tile<true>(acc, r.tile * BN + 2 * t, st);
  else
    fold_tile<false>(acc, r.tile * BN + 2 * t, st);
  if (++r.tile == ntiles) {
    emit(st, dir, first + r.pair, row0, g, t, K);
    r.tile = 0;
    ++r.pair;
  }
}

// Block b < d0.n_groups * row_blocks: row block b % row_blocks of group
// b / row_blocks of the listed pairs; the later blocks the same over the
// swapped list d1.
__global__ void __launch_bounds__(THREADS, 1)
pairs_kernel(__grid_constant__ const CUtensorMap map, const __nv_bfloat16* __restrict__ desc,
             const float* __restrict__ bias, int K, int Kp, int row_blocks, int stages,
             __grid_constant__ const Dir d0, __grid_constant__ const Dir d1) {
  extern __shared__ uint8_t ring_raw[];
  __shared__ uint64_t full_bar[MAX_STAGES], empty_bar[MAX_STAGES];
  const uint32_t ring = (smem_u32(ring_raw) + 1023u) & ~1023u;   // the swizzle's alignment
  const uint32_t bias_ring = ring + stages * TILE_BYTES;
  const int b0 = d0.n_groups * row_blocks;
  const bool swapped = static_cast<int>(blockIdx.x) >= b0;
  const Dir& dir = swapped ? d1 : d0;     // read from the parameters where needed
  const int bid = swapped ? blockIdx.x - b0 : blockIdx.x;
  const int group = bid / row_blocks, rb = bid - group * row_blocks;
  const int first = dir.group_start[group], last = dir.group_start[group + 1];
  const int ntiles = Kp / BN;
  const int n_tiles = (last - first) * ntiles;                     // >= 1: groups are not empty

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
      int stage = 0, n = first, tile = 0;
      uint32_t phase = 1;          // a fresh ring is empty: the first waits pass
      int b = dir.pairs[2 * n + 1];
      for (int k = 0; k < n_tiles; ++k) {
        const uint32_t full = smem_u32(&full_bar[stage]);
        mbar_wait(smem_u32(&empty_bar[stage]), phase);
        mbar_expect_tx(full, TILE_BYTES + BIAS_BYTES);
        const uint32_t dst = ring + stage * TILE_BYTES;
        const int row = b * K + tile * BN;
        tma_load_2d(dst, &map, full, 0, row);
        tma_load_2d(dst + BN * BOX_K * 2, &map, full, BOX_K, row);
        bulk_load(bias_ring + stage * BIAS_BYTES, bias + ((size_t)b * ntiles + tile) * BIAS_ROW,
                  BIAS_BYTES, full);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
        if (++tile == ntiles && k + 1 < n_tiles) {
          tile = 0;
          b = dir.pairs[2 * ++n + 1];
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, two accumulator sets ---------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = rb * BM + wg * WG_ROWS + warp * 16;
    const __nv_bfloat16* A = desc + (size_t)dir.pairs[2 * first] * K * D;

    // A fragments of wgmma m64k16 (warp w holds rows 16w..16w+15): reg0 = row
    // g, k 2t..2t+1; reg1 = row g+8; reg2/reg3 the same at k+8.  Rows past
    // K read as zero and are never written.
    uint32_t a[KSTEPS][4];
    {
      const int ra = row0 + g, rc = ra + 8;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int k = ks * 16 + 2 * t;
        const uint32_t* pa = reinterpret_cast<const uint32_t*>(A + (size_t)ra * D + k);
        const uint32_t* pc = reinterpret_cast<const uint32_t*>(A + (size_t)rc * D + k);
        a[ks][0] = ra < K ? pa[0] : 0u;
        a[ks][1] = rc < K ? pc[0] : 0u;
        a[ks][2] = ra < K ? pa[4] : 0u;
        a[ks][3] = rc < K ? pc[4] : 0u;
      }
    }

    Rows st;
    st.reset();
    float acc0[BN / 2], acc1[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.0f;

    const float* bias_s = reinterpret_cast<const float*>(ring_raw + (bias_ring - smem_u32(ring_raw)));
    Ring rs{ring, smem_u32(full_bar), smem_u32(empty_bar), bias_s, stages, 0, 0, 0u, 0, 0};
    start_tile(rs, acc0, a, t);
    int j = 0;
    for (; j + 2 < n_tiles; j += 2) {    // tile j is in flight in acc0; j+1 and j+2 exist
      start_tile(rs, acc1, a, t);
      wgmma_wait<1>();
      retire(rs, acc0, st, dir, !swapped, first, ntiles, row0, lane, K);
      start_tile(rs, acc0, a, t);
      wgmma_wait<1>();
      retire(rs, acc1, st, dir, !swapped, first, ntiles, row0, lane, K);
    }
    if (j + 1 < n_tiles) {
      start_tile(rs, acc1, a, t);
      wgmma_wait<1>();
      retire(rs, acc0, st, dir, !swapped, first, ntiles, row0, lane, K);
      wgmma_wait<0>();
      retire(rs, acc1, st, dir, !swapped, first, ntiles, row0, lane, K);
    } else {
      wgmma_wait<0>();
      retire(rs, acc0, st, dir, !swapped, first, ntiles, row0, lane, K);
    }
  }
}

// One thread per (listed pair n, a-row r): ratio test, masks, mutual check
// by index; masked a-rows get score NEG and index 0.
__global__ void finish_kernel(const int* __restrict__ pairs, const int* __restrict__ out_row,
                              const uint8_t* __restrict__ masks, int N, int K, float ratio2,
                              int cross_check, float* __restrict__ score, int* __restrict__ idx,
                              const float* __restrict__ s2, const int* __restrict__ j1,
                              uint8_t* __restrict__ valid) {
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (size_t)N * K) return;
  const int n = static_cast<int>(gid / K), r = static_cast<int>(gid % K);
  const size_t o = (size_t)out_row[n] * K;
  const int a = pairs[2 * n];
  const float s1 = score[o + r];
  const int i = idx[o + r];
  const bool ma = masks[(size_t)a * K + r] != 0;
  const float d1 = fmaxf(2.f - 2.f * s1, 0.f);
  const float d2 = fmaxf(2.f - 2.f * s2[o + r], 1e-12f);
  bool ok = (d1 < ratio2 * d2) && (s1 > NEG / 2) && ma;
  if (cross_check && ok) ok = j1[o + i] == r;
  valid[o + r] = ok;
  if (!ma) {
    score[o + r] = NEG;
    idx[o + r] = 0;
  }
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

}  // namespace

extern "C" {

// desc (C,K,128) bf16 contiguous; bias (C, Kp/128, 132) f32, Kp a multiple of
// 128 >= K: per image and tile of 128 columns, 0 for an unmasked column, NEG
// for a masked one and for j >= K, then 1.0 where any of them is NEG (else 0)
// and 3 unused floats.
// Direction 0: pairs0 (N0,2) int32 (row image, column image), out_row0 (N0,),
// group_start0 (G0+1,): consecutive pairs of a group share their row image.
// Direction 1 (G1 = 0 to skip it): the swapped list, likewise.
// Outputs (n_out,K) at out_row: score f32, idx i32, s2 f32 (direction 0),
// j1 i32 (direction 1).  Match mode (valid != null): a finish launch over
// the N0 pairs applies the ratio test, the masks (C,K) uint8 and, with
// cross_check, the mutual check through j1, and writes valid u8.  Raw mode
// (valid == null): one launch, no masks.  `stages` tiles in the ring.
// Returns cudaGetLastError() after the last launch, cudaErrorInvalidValue, or
// a negative code where the tensor map could not be encoded (see
// mp_error_string).
int mp_match_pairs(const void* desc, int C, int K, const float* bias, int Kp,
                   const int* pairs0, const int* out_row0, const int* group_start0, int n_groups0,
                   int n_pairs0, const int* pairs1, const int* out_row1,
                   const int* group_start1, int n_groups1, const uint8_t* masks, float ratio2,
                   int cross_check, float* score, int* idx, float* s2, int* j1, uint8_t* valid,
                   int stages, void* stream) {
  if (C <= 0 || K <= 0 || Kp < K || Kp % BN != 0 || n_groups0 < 0 || n_groups1 < 0 ||
      n_pairs0 < 0 || stages < 2 || stages > MAX_STAGES || (long long)C * K > 0x7FFFFFFFll ||
      (valid != nullptr && masks == nullptr) || (n_groups1 > 0 && j1 == nullptr))
    return cudaErrorInvalidValue;
  const int row_blocks = (K + BM - 1) / BM;
  const long long blocks = (long long)(n_groups0 + n_groups1) * row_blocks;
  if (blocks > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return ERR_NO_ENCODER;
    CUtensorMap map;
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)C * K};   // innermost first
    const cuuint64_t strides[1] = {(cuuint64_t)D * 2};                // bytes between rows
    const cuuint32_t box[2] = {(cuuint32_t)BOX_K, (cuuint32_t)BN};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(desc), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return ERR_ENCODE;
    const int smem = stages * (TILE_BYTES + BIAS_BYTES) + 1024;
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const Dir d0{pairs0, out_row0, group_start0, n_groups0, score, idx, s2};
    const Dir d1{pairs1, out_row1, group_start1, n_groups1, nullptr, j1, nullptr};
    pairs_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
        map, static_cast<const __nv_bfloat16*>(desc), bias, K, Kp, row_blocks, stages, d0, d1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (valid == nullptr || n_pairs0 == 0) return cudaSuccess;
  const size_t total = (size_t)n_pairs0 * K;
  finish_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      pairs0, out_row0, masks, n_pairs0, K, ratio2, cross_check, score, idx, s2, j1, valid);
  return cudaGetLastError();
}

const char* mp_error_string(int err) {
  if (err == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in libcuda";
  if (err == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the descriptors' tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mp_desc_width() { return D; }

}  // extern "C"
