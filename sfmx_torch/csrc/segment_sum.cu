// Fixed-order segment sums for bundle adjustment's normal equations.
//
// out[s] = sum of the rows x[perm[r]] for r in segment s's range of the
// sorted order.  The order of every addition is a function of the plan alone
// (no atomics), so a sum gives the same bits on every run: lane j of the warp
// that owns a piece of at most PIECE_ROWS sorted rows adds rows j, j+32, ...
// one after another, then the 32 lane sums meet in a butterfly of shuffles.
// A segment longer than one piece is summed in two launches: every piece
// into a partial row, then each segment's partial rows by the same warp
// sum (an identity permutation), in piece order.
//
// Columns are summed COLS at a time, each lane holding COLS accumulators in
// registers; a row of D values is read in ceil(D / COLS) chunks.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps (pieces) per block
constexpr int COLS = 12;  // columns a lane accumulates at once

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    piece_sum_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                     const int* __restrict__ off, int n, int D, T* __restrict__ dst) {
  const int w = blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= n) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int beg = off[w], end = off[w + 1];
  T* out = dst + (size_t)w * D;
  for (int c0 = 0; c0 < D; c0 += COLS) {
    const int nc = min(COLS, D - c0);
    T acc[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) acc[k] = T(0);
    for (int r = beg + lane; r < end; r += 32) {
      const T* row = x + (size_t)(perm ? perm[r] : r) * D + c0;
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        if (k < nc) acc[k] += row[k];
    }
    T mine = T(0);
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      T v = acc[k];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
      if (k == lane) mine = v;
    }
    if (lane < nc) out[c0 + lane] = mine;
  }
}

template <typename T>
cudaError_t launch(const T* x, const int* perm, const int* piece_off, int n_pieces,
                   const int* seg_piece, int n, int D, T* partial, T* out, cudaStream_t st) {
  const int blocks1 = (n_pieces + WARPS - 1) / WARPS;
  if (seg_piece == nullptr) {
    piece_sum_kernel<T><<<blocks1, WARPS * 32, 0, st>>>(x, perm, piece_off, n_pieces, D, out);
    return cudaGetLastError();
  }
  piece_sum_kernel<T><<<blocks1, WARPS * 32, 0, st>>>(x, perm, piece_off, n_pieces, D, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  piece_sum_kernel<T><<<(n + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(partial, nullptr, seg_piece,
                                                                      n, D, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (O, D) rows, f32 (f64 = 0) or f64 (f64 = 1); perm (O,) i32 the rows in
// segment order; piece_off (n_pieces+1,) i32 offsets of the pieces in that
// order.  seg_piece null: the pieces are the n segments (n_pieces == n) and
// the launch writes out (n, D).  Otherwise seg_piece (n+1,) i32 offsets of
// each segment's pieces, partial a (n_pieces, D) scratch, and a second
// launch sums them into out.  Returns cudaGetLastError() after the launches.
int segment_sum(const void* x, const int* perm, const int* piece_off, int n_pieces,
                const int* seg_piece, int n, int D, void* partial, void* out, int f64,
                void* stream) {
  if (n <= 0 || D <= 0 || n_pieces < n || (seg_piece == nullptr && n_pieces != n))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch<double>(static_cast<const double*>(x), perm, piece_off, n_pieces, seg_piece, n,
                          D, static_cast<double*>(partial), static_cast<double*>(out), st);
  return launch<float>(static_cast<const float*>(x), perm, piece_off, n_pieces, seg_piece, n, D,
                       static_cast<float*>(partial), static_cast<float*>(out), st);
}

const char* segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
