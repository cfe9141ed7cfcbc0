// K4 match_top2: streaming top-2 of a bf16 descriptor GEMM for Hopper.
//
// Replaces the TPU kernel sfmx/kernels/pallas_match.py match_top2
// (_match_kernel).  For every query row a, over all landmark rows b:
//   s1 = max_b bf16(a).bf16(b) accumulated in f32, i1 = its lowest argmax,
//   s2 = the largest score of any column other than i1 (== s1 on a tie).
// The (Ka,Kb) similarity matrix never exists.
//
// What bounds it on the H100: arithmetic.  At the serving shape (32 queries
// x 1024 keypoints against >= 131,072 landmarks, D = 128) one call is
// ~1.1 TFLOP and reads only ~8 MB of queries and ~34 MB of landmarks (the
// pool stays in the 50 MB L2), so the tensor cores, and the per-score
// top-2 bookkeeping beside them, are the limit.
//
// The TPU kernel carried the running top-2 through a sequential grid in
// lane-padded VMEM scratch.  GPU blocks run in no order, so here each
// block owns BM = 128 query rows for the whole landmark loop and nothing
// carries between blocks:
// - 4 warps x 32 rows; each warp keeps its A fragments (32 rows x 128
//   bf16) in registers for the whole call;
// - landmark tiles of BN = 64 rows are staged through shared memory with
//   cp.async, double-buffered (the row stride is padded to 136 bf16 so the
//   B-fragment reads are free of bank conflicts);
// - scores come from bf16 mma.sync m16n8k16 with f32 accumulation (the
//   products of bf16 values are exact in f32, so only the summation order
//   differs from the plain version);
// - each thread folds its accumulator values straight into a running
//   (best, argbest, second) for its 4 rows over its columns, visited in
//   increasing order, so the strict '>' keeps the lowest index;
// - at the end the 4 threads that share a row merge with shuffles, ties to
//   the lower index, second = max of the loser's best and both seconds.
// A first, simple kernel: no wgmma or TMA yet, and no split of the
// landmark loop across blocks, so Ka below ~17k rows leaves SMs idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // descriptor width (the wrapper zero-pads up to it)
constexpr int BM = 128;         // query rows per block
constexpr int BN = 64;          // landmark rows per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;      // padded shared row stride (bf16 elements)
constexpr int KSTEPS = D / 16;  // mma k-steps per row
constexpr float NEG = -1e30f;   // the reference's running-max init

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

// Load one BN x D landmark tile into shared memory (16-byte chunks).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* B,
                                          int n0, int tid) {
  constexpr int CHUNKS_PER_ROW = D * 2 / 16;  // 16
  constexpr int CHUNKS = BN * CHUNKS_PER_ROW;
#pragma unroll
  for (int c = tid; c < CHUNKS; c += THREADS) {
    const int row = c / CHUNKS_PER_ROW, col = (c % CHUNKS_PER_ROW) * 8;
    cp_async16(dst + row * LDS + col, B + (size_t)(n0 + row) * D + col);
  }
}

__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                  int Ka, int Kb, float* __restrict__ s1_out, int* __restrict__ i1_out,
                  float* __restrict__ s2_out) {
  __shared__ __align__(16) __nv_bfloat16 bs[2][BN * LDS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM + warp * 32;

  // A fragments of m16n8k16 (row-major 16x16 per k-step): reg0 = row g,
  // k 2t..2t+1; reg1 = row g+8; reg2/reg3 the same at k+8.  Rows past Ka
  // read as zero and are never written.
  uint32_t a[2][KSTEPS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = row0 + mt * 16 + g, rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k = ks * 16 + 2 * t;
      const uint32_t* pa = reinterpret_cast<const uint32_t*>(A + (size_t)ra * D + k);
      const uint32_t* pb = reinterpret_cast<const uint32_t*>(A + (size_t)rb * D + k);
      a[mt][ks][0] = ra < Ka ? pa[0] : 0u;
      a[mt][ks][1] = rb < Ka ? pb[0] : 0u;
      a[mt][ks][2] = ra < Ka ? pa[4] : 0u;
      a[mt][ks][3] = rb < Ka ? pb[4] : 0u;
    }
  }

  // running top-2 of this thread's 4 rows: [mt][half] -> row g + 8*half
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

  const int ntiles = Kb / BN;
  load_tile(bs[0], B, 0, tid);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // tile is in shared memory; everyone is done with tile-1
    if (tile + 1 < ntiles) load_tile(bs[(tile + 1) & 1], B, (tile + 1) * BN, tid);
    cp_async_commit();
    const __nv_bfloat16* cur = bs[tile & 1];
#pragma unroll 2
    for (int nt = 0; nt < BN / 8; ++nt) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      // B fragment (col-major 16x8): reg0 = column g, k 2t..2t+1; reg1 at k+8.
      const uint32_t* pb = reinterpret_cast<const uint32_t*>(cur + (nt * 8 + g) * LDS + 2 * t);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t w0 = pb[ks * 8], w1 = pb[ks * 8 + 4];
        mma_bf16(acc[0], a[0][ks], w0, w1);
        mma_bf16(acc[1], a[1][ks], w0, w1);
      }
      // C fragment: c0/c1 = row g, columns 2t/2t+1; c2/c3 = row g+8.
      const int col = tile * BN + nt * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        fold(acc[mt][0], col, b1[mt][0], b2[mt][0], i1[mt][0]);
        fold(acc[mt][1], col + 1, b1[mt][0], b2[mt][0], i1[mt][0]);
        fold(acc[mt][2], col, b1[mt][1], b2[mt][1], i1[mt][1]);
        fold(acc[mt][3], col + 1, b1[mt][1], b2[mt][1], i1[mt][1]);
      }
    }
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
      if (t == 0 && r < Ka) {
        s1_out[r] = x1;
        i1_out[r] = xi;
        s2_out[r] = x2;
      }
    }
}

}  // namespace

extern "C" {

// A (Ka,128) bf16, B (Kb,128) bf16, both contiguous; Kb % 64 == 0.
// Writes s1 (Ka,) f32, i1 (Ka,) i32, s2 (Ka,) f32 on the given stream.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue).
int mt_match_top2(const void* A, const void* B, int Ka, int Kb, float* s1, int* i1,
                  float* s2, void* stream) {
  if (Ka < 0 || Kb <= 0 || Kb % BN != 0) return cudaErrorInvalidValue;
  if (Ka == 0) return cudaSuccess;
  const int blocks = (Ka + BM - 1) / BM;
  match_top2_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B), Ka, Kb,
      s1, i1, s2);
  return cudaGetLastError();
}

const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mt_tile_rows() { return BN; }

}  // extern "C"
