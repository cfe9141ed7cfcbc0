// K3 describe_upright: upright patch cell features for Hopper.
//
// Replaces the TPU kernel sfmx/kernels/pallas_describe.py describe_upright
// (_describe_kernel).  Per keypoint: a 24x24 bilinear resample spanning
// 20 sigma on the keypoint's scale level, one-sided/central patch
// gradients, and the 87 cell features (2x2, 3x3 and 4x4 grids x mean, dx,
// dy), written as a 128-wide row (columns 87..127 and masked rows zero).
//
// What bounds it on the H100: latency of scattered reads.  A keypoint reads
// ~2.3k level values (4 per sample, mostly shared between neighbours) and
// does ~10k flops, so neither bandwidth nor arithmetic is the limit; what
// matters is that the reads coalesce and that nothing round-trips through
// device memory.  The TPU kernel DMA'd a 256x256 window into VMEM and
// resampled it with two interpolation-matrix GEMMs on the MXU, then pooled
// the cells outside the kernel; none of that is needed on a GPU.
//
// Design: one block per keypoint, one thread per patch sample (576).
// Samples go straight from the level (neighbouring threads read
// neighbouring addresses) into shared memory; gradients and the 87 cell
// means are computed from shared memory, so the block writes only its
// 128-float row.  Sampling follows the plain version exactly: the level is
// zero-padded (virtually) to Hp x Wp, coordinates are clipped to
// [0, Wp-1.001] x [0, Hp-1.001], and positions are x0 + fx + off with the
// aligned window origin x0 of _window_params.  Position arithmetic uses
// round-to-nearest intrinsics so no fused multiply-add changes a floor().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PATCH = 24;
constexpr int NT = PATCH * PATCH;  // threads per block
constexpr int OUT_DIM = 128;
constexpr int N_RAW = 87;
constexpr int WIN = 256;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float level_at(const float* img, int y, int x,
                                          int H, int W) {
  return (y < H && x < W) ? img[(size_t)y * W + x] : 0.0f;  // zero padding
}

__global__ void __launch_bounds__(NT)
describe_kernel(const float* __restrict__ levels, const float* __restrict__ uv,
                const int* __restrict__ level, const float* __restrict__ sigma,
                const uint8_t* __restrict__ mask, float* __restrict__ out,
                int L, int H, int W, int Hp, int Wp, int K, float xmax,
                float ymax) {
  __shared__ float p[PATCH][PATCH];
  __shared__ float gdx[PATCH][PATCH];
  __shared__ float gdy[PATCH][PATCH];
  const int kp = blockIdx.x;  // b * K + k
  const int b = kp / K;
  const int tid = threadIdx.x;
  float* row = out + (size_t)kp * OUT_DIM;
  if (!mask[kp]) {  // uniform across the block
    if (tid < OUT_DIM) row[tid] = 0.0f;
    return;
  }
  const float u = uv[2 * kp], v = uv[2 * kp + 1];
  const float sp = __fdiv_rn(__fmul_rn(20.0f, sigma[kp]), (float)(PATCH - 1));
  int y0 = (int)floorf(__fsub_rn(v, 64.0f));
  y0 = min(max(floordiv(y0, 8) * 8, 0), Hp - WIN);
  int x0 = (int)floorf(__fsub_rn(u, 64.0f));
  x0 = min(max(floordiv(x0, 128) * 128, 0), Wp - WIN);
  const float fx = __fsub_rn(u, (float)x0);
  const float fy = __fsub_rn(v, (float)y0);
  const float* img = levels + ((size_t)b * L + level[kp]) * H * W;

  const int i = tid / PATCH, j = tid % PATCH;  // row (y), column (x)
  float xs = __fadd_rn(__fadd_rn((float)x0, fx),
                       __fmul_rn(__fsub_rn((float)j, 11.5f), sp));
  float ys = __fadd_rn(__fadd_rn((float)y0, fy),
                       __fmul_rn(__fsub_rn((float)i, 11.5f), sp));
  xs = fminf(fmaxf(xs, 0.0f), xmax);
  ys = fminf(fmaxf(ys, 0.0f), ymax);
  const int xi = (int)floorf(xs), yi = (int)floorf(ys);
  const float ax = xs - (float)xi, ay = ys - (float)yi;
  const float v00 = level_at(img, yi, xi, H, W);
  const float v01 = level_at(img, yi, xi + 1, H, W);
  const float v10 = level_at(img, yi + 1, xi, H, W);
  const float v11 = level_at(img, yi + 1, xi + 1, H, W);
  p[i][j] = v00 * (1.0f - ax) * (1.0f - ay) + v01 * ax * (1.0f - ay) +
            v10 * (1.0f - ax) * ay + v11 * ax * ay;
  __syncthreads();

  // in-patch gradients: one-sided at the edges, central inside
  gdx[i][j] = (j == 0)           ? p[i][1] - p[i][0]
              : (j == PATCH - 1) ? p[i][PATCH - 1] - p[i][PATCH - 2]
                                 : 0.5f * (p[i][j + 1] - p[i][j - 1]);
  gdy[i][j] = (i == 0)           ? p[1][j] - p[0][j]
              : (i == PATCH - 1) ? p[PATCH - 1][j] - p[PATCH - 2][j]
                                 : 0.5f * (p[i + 1][j] - p[i - 1][j]);
  __syncthreads();

  if (tid < OUT_DIM) {
    float val = 0.0f;
    if (tid < N_RAW) {
      // layout: per grid g in (2,3,4): [mean | dx | dy], each g*g cells row-major
      int g, r;
      if (tid < 12) { g = 2; r = tid; }
      else if (tid < 39) { g = 3; r = tid - 12; }
      else { g = 4; r = tid - 39; }
      const int ch = r / (g * g), cell = r % (g * g);
      const int cs = PATCH / g;
      const int cy = (cell / g) * cs, cx = (cell % g) * cs;
      const float (*src)[PATCH] = ch == 0 ? p : (ch == 1 ? gdx : gdy);
      float s = 0.0f;
      for (int yy = 0; yy < cs; ++yy) {
        float rs = 0.0f;
        for (int xx = 0; xx < cs; ++xx) rs += src[cy + yy][cx + xx];
        s += rs / (float)cs;
      }
      val = s / (float)cs;
    }
    row[tid] = val;
  }
}

}  // namespace

extern "C" {

// levels (B,L,H,W) f32; uv (B,K,2) f32; level (B,K) i32; sigma (B,K) f32;
// mask (B,K) bool; out (B,K,128) f32.  Hp/Wp are the padded sizes the
// sampling is defined on.  Returns cudaGetLastError().
int dsc_describe_upright(const float* levels, const float* uv, const int* level,
                         const float* sigma, const uint8_t* mask, float* out,
                         int B, int L, int H, int W, int Hp, int Wp, int K,
                         float xmax, float ymax, void* stream) {
  if (B * K == 0) return cudaSuccess;
  describe_kernel<<<B * K, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, uv, level, sigma, mask, out, L, H, W, Hp, Wp, K, xmax, ymax);
  return cudaGetLastError();
}

const char* dsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
