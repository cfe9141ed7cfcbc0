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
//   - per b-column: the best a-row among unmasked rows, lowest row on a tie;
//   - finish: the Lowe ratio test on d = 2 - 2s, the masks, and the mutual
//     check "the column's best row of i1 is this row" (the dense matcher's
//     index cross-check, sfmx/kernels/matching.py:match_similarity).  Masked
//     a-rows get score NEG and index 0, as the dense matcher gives them.
// The raw mode (K10) has no masks and no tests: it returns s1, i1, s2 and the
// column argmax j1.  The (K,K) matrix never leaves the SM.
//
// What bounds it on the H100: arithmetic.  At the cli default (K = 1024,
// D = 128) a pair is 0.27 GFLOP against 0.5 MB of descriptors, which stay in
// the 50 MB L2 across the pairs that share an image; the bf16 tensor cores
// and the per-score bookkeeping beside them (a row top-2 fold and a column
// max) are the limit.
//
// The TPU kernel fetched G = 8 pairs per sequential grid step by manual DMA
// into VMEM and reduced a transposed (K,K) tile there.  Here a block owns
// BM = 128 a-rows of one pair (K5) or of one a-image and up to 8 b-images of
// its tile (K9, whose A fragments then load once for all of them):
// - 4 warps x 32 rows; each warp keeps its A fragments in registers;
// - b rows stream through shared memory in 64-row cp.async tiles,
//   double-buffered (row stride padded to 136 bf16: conflict-free fragment
//   reads), with the tile's 64 column-mask bytes beside them;
// - bf16 mma.sync m16n8k16 with f32 accumulation (bf16 products are exact
//   in f32; only the order of the 128-term sums differs from the plain
//   version);
// - the row top-2 folds in increasing column order with a strict '>', so
//   the lowest index keeps a tie; the 4 threads of a row merge by shuffles;
// - the column max: each thread takes its 4 rows, the 8 lanes of a column
//   merge by shuffles, the 4 warps by a 64-bit shared-memory atomicMax, and
//   each tile's 64 columns go out with one global atomicMax per column into
//   an (N,K) u64 buffer.  The key is orderable-f32-bits << 32 | ~row, so the
//   larger score wins and, on a tie, the lower row, as jnp.argmax does;
//   blocks of one pair meet only there, in no order, and max is exact.
// A second small launch (finish_kernel) applies the tests, or decodes j1.
// A first, simple kernel: no wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // descriptor width (the wrapper zero-pads up to it)
constexpr int BM = 128;         // a-rows per block
constexpr int BN = 64;          // b-rows per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;      // padded shared row stride (bf16 elements)
constexpr int KSTEPS = D / 16;  // mma k-steps per row
constexpr float NEG = -1e30f;   // the dense matcher's masked score

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fold score s of column j into a running top-2 whose columns all precede j.
__device__ __forceinline__ void fold(float s, int j, float& b1, float& b2, int& i1) {
  const bool gt = s > b1;
  b2 = gt ? b1 : fmaxf(b2, s);
  i1 = gt ? j : i1;
  b1 = gt ? s : b1;
}

// Column-max key: larger score first, then the lower row.  -0 counts as +0.
__device__ __forceinline__ unsigned long long col_key(float v, int row) {
  unsigned u = __float_as_uint(v + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(row));
}
__device__ __forceinline__ int key_row(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull));
}

// Load b-rows [n0, n0+BN) of one image (rows >= K as zeros) and their
// column-mask bytes (0 past K; all 1 without masks).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, uint8_t* mdst,
                                          const __nv_bfloat16* B, const uint8_t* mb,
                                          int n0, int K, int tid) {
  constexpr int CHUNKS_PER_ROW = D * 2 / 16;  // 16
  constexpr int CHUNKS = BN * CHUNKS_PER_ROW;
#pragma unroll
  for (int c = tid; c < CHUNKS; c += THREADS) {
    const int row = c / CHUNKS_PER_ROW, col = (c % CHUNKS_PER_ROW) * 8;
    __nv_bfloat16* d = dst + row * LDS + col;
    if (n0 + row < K)
      cp_async16(d, B + (size_t)(n0 + row) * D + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid < BN) {
    const int j = n0 + tid;
    mdst[tid] = j < K ? (mb ? mb[j] : uint8_t(1)) : uint8_t(0);
  }
}

// One block: a-rows [rb*BM, rb*BM+BM) of image a against the b-images of
// pairs [first, last) of the processing list (all with the same a).
//   pairs (N,2) int32 (a, b); out_row (N,) or null (identity);
//   masks (C,K) uint8 or null (raw mode: no masks);
//   s1/i1 at out_row[n], s2 and colkey at n.
__global__ void __launch_bounds__(THREADS)
pairs_kernel(const __nv_bfloat16* __restrict__ desc, const uint8_t* __restrict__ masks, int K,
             const int* __restrict__ pairs, const int* __restrict__ out_row,
             const int* __restrict__ group_start, int row_blocks,
             float* __restrict__ s1_out, int* __restrict__ i1_out, float* __restrict__ s2_out,
             unsigned long long* __restrict__ colkey) {
  __shared__ __align__(16) __nv_bfloat16 bs[2][BN * LDS];
  __shared__ uint8_t ms[2][BN];
  __shared__ unsigned long long ck[2][BN];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = blockIdx.x / row_blocks, rb = blockIdx.x % row_blocks;
  const int first = group_start ? group_start[group] : group;
  const int last = group_start ? group_start[group + 1] : group + 1;
  const int a = pairs[2 * first];
  const int row0 = rb * BM + warp * 32;
  const __nv_bfloat16* A = desc + (size_t)a * K * D;

  // A fragments of m16n8k16 (row-major 16x16 per k-step): reg0 = row g,
  // k 2t..2t+1; reg1 = row g+8; reg2/reg3 the same at k+8.  Rows past K
  // read as zero and are never written.
  uint32_t af[2][KSTEPS][4];
  bool rv[2][2];  // this thread's 4 rows take part in the column max
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = row0 + mt * 16 + g, rb8 = ra + 8;
    rv[mt][0] = ra < K && (masks == nullptr || masks[(size_t)a * K + ra]);
    rv[mt][1] = rb8 < K && (masks == nullptr || masks[(size_t)a * K + rb8]);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k = ks * 16 + 2 * t;
      const uint32_t* pa = reinterpret_cast<const uint32_t*>(A + (size_t)ra * D + k);
      const uint32_t* pb = reinterpret_cast<const uint32_t*>(A + (size_t)rb8 * D + k);
      af[mt][ks][0] = ra < K ? pa[0] : 0u;
      af[mt][ks][1] = rb8 < K ? pb[0] : 0u;
      af[mt][ks][2] = ra < K ? pa[4] : 0u;
      af[mt][ks][3] = rb8 < K ? pb[4] : 0u;
    }
  }
  if (tid < BN) {
    ck[0][tid] = 0ull;
    ck[1][tid] = 0ull;
  }
  const int ntiles = (K + BN - 1) / BN;

  for (int n = first; n < last; ++n) {
    const int b = pairs[2 * n + 1];
    const int o = out_row ? out_row[n] : n;
    const __nv_bfloat16* B = desc + (size_t)b * K * D;
    const uint8_t* mb = masks ? masks + (size_t)b * K : nullptr;
    unsigned long long* colkey_n = colkey + (size_t)n * K;

    float b1[2][2], b2[2][2];
    int i1[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b1[mt][h] = NEG;
        b2[mt][h] = NEG;
        i1[mt][h] = 0;
      }

    __syncthreads();  // the previous pair is done with the shared buffers
    load_tile(bs[0], ms[0], B, mb, 0, K, tid);
    cp_async_commit();
    for (int tile = 0; tile < ntiles; ++tile) {
      cp_async_wait_all();
      __syncthreads();  // tile is in shared memory; everyone is done with tile-1
      if (tile > 0 && tid < BN) {  // publish tile-1's column maxima
        const int j = (tile - 1) * BN + tid;
        unsigned long long& c = ck[(tile - 1) & 1][tid];
        if (c != 0ull && j < K) atomicMax(colkey_n + j, c);
        c = 0ull;
      }
      if (tile + 1 < ntiles)
        load_tile(bs[(tile + 1) & 1], ms[(tile + 1) & 1], B, mb, (tile + 1) * BN, K, tid);
      cp_async_commit();
      const __nv_bfloat16* cur = bs[tile & 1];
      const uint8_t* mcur = ms[tile & 1];
      unsigned long long* ckcur = ck[tile & 1];
#pragma unroll 2
      for (int nt = 0; nt < BN / 8; ++nt) {
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        // B fragment (col-major 16x8): reg0 = column g, k 2t..2t+1; reg1 at k+8.
        const uint32_t* pb = reinterpret_cast<const uint32_t*>(cur + (nt * 8 + g) * LDS + 2 * t);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const uint32_t w0 = pb[ks * 8], w1 = pb[ks * 8 + 4];
          mma_bf16(acc[0], af[0][ks], w0, w1);
          mma_bf16(acc[1], af[1][ks], w0, w1);
        }
        // C fragment: c0/c1 = row g, columns 2t/2t+1; c2/c3 = row g+8.
        const int lc = nt * 8 + 2 * t;
        const int col = tile * BN + lc;
        const bool m0 = mcur[lc] != 0, m1 = mcur[lc + 1] != 0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          fold(m0 ? acc[mt][0] : NEG, col, b1[mt][0], b2[mt][0], i1[mt][0]);
          fold(m1 ? acc[mt][1] : NEG, col + 1, b1[mt][0], b2[mt][0], i1[mt][0]);
          fold(m0 ? acc[mt][2] : NEG, col, b1[mt][1], b2[mt][1], i1[mt][1]);
          fold(m1 ? acc[mt][3] : NEG, col + 1, b1[mt][1], b2[mt][1], i1[mt][1]);
        }
        // column max over this thread's rows g, g+8, g+16, g+24 (increasing)
        float cv[2] = {-CUDART_INF_F, -CUDART_INF_F};
        int cr[2] = {0, 0};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + mt * 16 + h * 8 + g;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float v = acc[mt][2 * h + c];
              if (rv[mt][h] && v > cv[c]) {
                cv[c] = v;
                cr[c] = r;
              }
            }
          }
        // ... then over the 8 lanes that share the column (rows ascend with g)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int off = 4; off <= 16; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, cv[c], off);
            const int orow = __shfl_xor_sync(0xffffffffu, cr[c], off);
            if (ov > cv[c] || (ov == cv[c] && orow < cr[c])) {
              cv[c] = ov;
              cr[c] = orow;
            }
          }
          if (g == 0 && cv[c] > -CUDART_INF_F) atomicMax(ckcur + lc + c, col_key(cv[c], cr[c]));
        }
      }
    }
    __syncthreads();
    if (tid < BN) {  // publish the last tile's column maxima
      const int j = (ntiles - 1) * BN + tid;
      unsigned long long& c = ck[(ntiles - 1) & 1][tid];
      if (c != 0ull && j < K) atomicMax(colkey_n + j, c);
      c = 0ull;
    }

    // merge the 4 threads of a quad (same rows, disjoint columns)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x1 = b1[mt][h], x2 = b2[mt][h];
        int xi = i1[mt][h];
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float o1 = __shfl_xor_sync(0xffffffffu, x1, off);
          const float o2 = __shfl_xor_sync(0xffffffffu, x2, off);
          const int oi = __shfl_xor_sync(0xffffffffu, xi, off);
          const bool take = o1 > x1 || (o1 == x1 && oi < xi);
          x2 = fmaxf(fminf(x1, o1), fmaxf(x2, o2));
          xi = take ? oi : xi;
          x1 = take ? o1 : x1;
        }
        const int r = row0 + mt * 16 + g + 8 * h;
        if (t == 0 && r < K) {
          s1_out[(size_t)o * K + r] = x1;
          i1_out[(size_t)o * K + r] = xi;
          s2_out[(size_t)n * K + r] = x2;
        }
      }
  }
}

// One thread per (listed pair n, a-row r).  Match mode: ratio test, masks,
// mutual check; masked a-rows get score NEG and index 0.  Raw mode: j1 of
// column r from the column-max key.
__global__ void finish_kernel(const int* __restrict__ pairs, const int* __restrict__ out_row,
                              const uint8_t* __restrict__ masks, int N, int K, float ratio2,
                              int cross_check, float* __restrict__ score, int* __restrict__ idx,
                              const float* __restrict__ s2, const unsigned long long* __restrict__ colkey,
                              uint8_t* __restrict__ valid, int* __restrict__ j1) {
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (size_t)N * K) return;
  const int n = static_cast<int>(gid / K), r = static_cast<int>(gid % K);
  const size_t o = (size_t)(out_row ? out_row[n] : n) * K + r;
  if (j1 != nullptr) {
    j1[o] = key_row(colkey[gid]);
    return;
  }
  const int a = pairs[2 * n];
  const float s1 = score[o];
  const int i = idx[o];
  const bool ma = masks[(size_t)a * K + r] != 0;
  const float d1 = fmaxf(2.f - 2.f * s1, 0.f);
  const float d2 = fmaxf(2.f - 2.f * s2[gid], 1e-12f);
  bool ok = (d1 < ratio2 * d2) && (s1 > NEG / 2) && ma;
  if (cross_check && ok) ok = key_row(colkey[(size_t)n * K + i]) == r;
  valid[o] = ok;
  if (!ma) {
    score[o] = NEG;
    idx[o] = 0;
  }
}

}  // namespace

extern "C" {

// desc (C,K,128) bf16 contiguous; masks (C,K) uint8 or null (raw mode);
// pairs (N,2) int32 processing list; out_row (N,) int32 or null (identity);
// group_start (G+1,) int32 or null (G = N, one pair per group): the pairs
// of a group share their a-image.  Outputs (n_out,K): score f32, idx i32,
// valid u8 (match mode) or j1 i32 (raw mode: pass j1, valid unused);
// scratch (N,K): s2 f32, colkey u64 (zeroed here).  Two launches on the
// given stream.  Returns cudaGetLastError() after them (or
// cudaErrorInvalidValue).
int mp_match_pairs(const void* desc, const uint8_t* masks, int K, const int* pairs,
                   const int* out_row, const int* group_start, int n_pairs, int n_groups,
                   float ratio2, int cross_check, float* score, int* idx, float* s2,
                   unsigned long long* colkey, uint8_t* valid, int* j1, void* stream) {
  if (K <= 0 || n_pairs < 0 || n_groups < 0 || (masks == nullptr) != (j1 != nullptr))
    return cudaErrorInvalidValue;
  if (n_pairs == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(colkey, 0, (size_t)n_pairs * K * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  const int row_blocks = (K + BM - 1) / BM;
  const long long blocks = (long long)(group_start ? n_groups : n_pairs) * row_blocks;
  if (blocks <= 0 || blocks > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  pairs_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(desc), masks, K, pairs, out_row, group_start, row_blocks,
      score, idx, s2, colkey);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)n_pairs * K;
  const unsigned fin_blocks = static_cast<unsigned>((total + 255) / 256);
  finish_kernel<<<fin_blocks, 256, 0, st>>>(pairs, out_row, masks, n_pairs, K, ratio2,
                                            cross_check, score, idx, s2, colkey, valid, j1);
  return cudaGetLastError();
}

const char* mp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mp_desc_width() { return D; }

}  // extern "C"
