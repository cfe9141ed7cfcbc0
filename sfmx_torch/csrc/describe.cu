// K3 describe_upright: upright patch cell features for Hopper.
//
// Replaces the TPU kernel sfmx/kernels/pallas_describe.py describe_upright
// (_describe_kernel).  Per keypoint: a 24x24 bilinear resample spanning
// 20 sigma on the keypoint's scale level, one-sided/central patch
// gradients, and the 87 cell features (2x2, 3x3 and 4x4 grids x mean, dx,
// dy), written as a 128-wide row (columns 87..127 and masked rows zero).
//
// What bounds it on the H100: bytes.  A keypoint's samples touch the outer
// product of up to 48 rows and 48 columns of its level (4 pixels a sample)
// for ~10k flops, and a batch of 32 VGA images touches over half of its
// levels, which do not fit L2: what matters is that every warp keeps many
// reads in flight and that nothing waits at a block-wide barrier.  The TPU
// kernel DMA'd a 256x256 window into VMEM and resampled it with two
// interpolation-matrix GEMMs on the MXU, then pooled the cells outside the
// kernel; none of that is needed on a GPU.
//
// Design: a WARP PER KEYPOINT, several keypoints per block, no block-wide
// barrier.  The descriptor is upright, so a sample's x position depends only
// on its column and its y position only on its row: lane j < 24 owns column
// j (one x position, then its 24 rows, all unrolled, so a lane has 96
// independent reads in flight) and keeps the column's samples in registers.
// Lanes 24..31 repeat column 23 (the same addresses, so no extra sectors)
// and their results are dropped.  dy is taken inside the lane, dx from
// lanes j-1 and j+1 by shuffles.  Pooling: each lane sums its column over
// the 9 row bands of the three grids (2 + 3 + 4) for the 3 channels, 27
// sums with compile-time bounds, into a per-warp shared array; then every
// lane forms at most 3 of the 87 cell means by adding at most 12 of those
// column sums, and the warp writes its 128-float row as 16-byte stores.
// A masked keypoint's warp writes zeros and leaves.
//
// Sampling is the plain version's, bit for bit: the level is zero-padded
// (virtually) to Hp x Wp, coordinates are clipped to [0, Wp-1.001] x
// [0, Hp-1.001], and positions are x0 + fx + off with the aligned window
// origin x0 of _window_params, computed with round-to-nearest intrinsics so
// no fused multiply-add changes a floor().  Only the order of the pooling
// sums differs from the plain version: a band sum adds its rows in order,
// a cell adds its columns' band sums in order and divides by the cell area
// (describe.describe_upright_columns mirrors this order on the CPU).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PATCH = 24;
constexpr int OUT_DIM = 128;
constexpr int N_RAW = 87;
constexpr int WIN = 256;
constexpr int N_SUMS = 3 * (2 + 3 + 4);        // 27 band sums of a column
constexpr int WARP_FLOATS = N_SUMS * PATCH;    // a warp's shared array
constexpr int MAX_KPB = 16;                    // keypoints (warps) per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float level_at(const float* img, int y, int x,
                                          int H, int W) {
  return (y < H && x < W) ? img[(size_t)y * W + x] : 0.0f;  // zero padding
}

// first band of grid g in the 27-sum layout [band][channel]
__host__ __device__ constexpr int band_base(int g) { return g == 2 ? 0 : (g == 3 ? 2 : 5); }

__global__ void __launch_bounds__(32 * MAX_KPB)
describe_kernel(const float* __restrict__ levels, const float* __restrict__ uv,
                const void* __restrict__ level, bool level64, const float* __restrict__ sigma,
                const uint8_t* __restrict__ mask, float* __restrict__ out,
                int n_kp, int L, int H, int W, int Hp, int Wp, int K, float xmax,
                float ymax) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = blockIdx.x * (blockDim.x >> 5) + warp;  // b * K + k
  if (kp >= n_kp) return;                                // warp-uniform
  float4* row4 = reinterpret_cast<float4*>(out + (size_t)kp * OUT_DIM);
  if (!mask[kp]) {
    row4[lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const int b = kp / K;
  const float u = uv[2 * kp], v = uv[2 * kp + 1];
  const float sp = __fdiv_rn(__fmul_rn(20.0f, sigma[kp]), (float)(PATCH - 1));
  int y0 = (int)floorf(__fsub_rn(v, 64.0f));
  y0 = min(max(floordiv(y0, 8) * 8, 0), Hp - WIN);
  int x0 = (int)floorf(__fsub_rn(u, 64.0f));
  x0 = min(max(floordiv(x0, 128) * 128, 0), Wp - WIN);
  const float fx = __fsub_rn(u, (float)x0);
  const float fy = __fsub_rn(v, (float)y0);
  const int lv = level64 ? (int)static_cast<const long long*>(level)[kp]
                         : static_cast<const int*>(level)[kp];
  const float* img = levels + ((size_t)b * L + lv) * H * W;

  const int j = min(lane, PATCH - 1);   // this lane's column
  float xs = __fadd_rn(__fadd_rn((float)x0, fx),
                       __fmul_rn(__fsub_rn((float)j, 11.5f), sp));
  xs = fminf(fmaxf(xs, 0.0f), xmax);
  const int xi = (int)floorf(xs);
  const float ax = xs - (float)xi;
  const float y00 = __fadd_rn((float)y0, fy);

  float p[PATCH];
#pragma unroll
  for (int i = 0; i < PATCH; ++i) {
    float ys = __fadd_rn(y00, __fmul_rn(__fsub_rn((float)i, 11.5f), sp));
    ys = fminf(fmaxf(ys, 0.0f), ymax);
    const int yi = (int)floorf(ys);
    const float ay = ys - (float)yi;
    const float v00 = level_at(img, yi, xi, H, W);
    const float v01 = level_at(img, yi, xi + 1, H, W);
    const float v10 = level_at(img, yi + 1, xi, H, W);
    const float v11 = level_at(img, yi + 1, xi + 1, H, W);
    p[i] = v00 * (1.0f - ax) * (1.0f - ay) + v01 * ax * (1.0f - ay) +
           v10 * (1.0f - ax) * ay + v11 * ax * ay;
  }

  // gradients and the column's band sums, rows in order
  float s[N_SUMS];
#pragma unroll
  for (int k = 0; k < N_SUMS; ++k) s[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < PATCH; ++i) {
    const float left = __shfl_up_sync(FULL, p[i], 1);
    const float right = __shfl_down_sync(FULL, p[i], 1);
    const float dx = (j == 0)           ? right - p[i]
                     : (j == PATCH - 1) ? p[i] - left
                                        : 0.5f * (right - left);
    const float dy = (i == 0)           ? p[1] - p[0]
                     : (i == PATCH - 1) ? p[PATCH - 1] - p[PATCH - 2]
                                        : 0.5f * (p[i + 1] - p[i - 1]);
#pragma unroll
    for (int g = 2; g <= 4; ++g) {
      const int band = band_base(g) + i / (PATCH / g);
      s[band * 3 + 0] += p[i];
      s[band * 3 + 1] += dx;
      s[band * 3 + 2] += dy;
    }
  }
  float* cols = smem + warp * WARP_FLOATS;   // [band * 3 + channel][column]
  if (lane < PATCH) {
#pragma unroll
    for (int k = 0; k < N_SUMS; ++k) cols[k * PATCH + lane] = s[k];
  }
  __syncwarp();

  // cell o = lane + 32 r; per grid g: [mean | dx | dy], g*g cells row-major
  float cell[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int o = lane + 32 * r;
    float val = 0.0f;
    if (o < N_RAW) {
      int g, q;
      if (o < 12) { g = 2; q = o; }
      else if (o < 39) { g = 3; q = o - 12; }
      else { g = 4; q = o - 39; }
      const int ch = q / (g * g), c = q % (g * g);
      const int cs = PATCH / g;
      const float* src = cols + ((band_base(g) + c / g) * 3 + ch) * PATCH + (c % g) * cs;
      float t = src[0];
      for (int x = 1; x < cs; ++x) t += src[x];
      val = t / (float)(cs * cs);
    }
    cell[r] = val;
  }
  __syncwarp();
  // the row, staged over the column sums, leaves as 16-byte stores
#pragma unroll
  for (int r = 0; r < 3; ++r) cols[lane + 32 * r] = cell[r];
  cols[lane + 96] = 0.0f;
  __syncwarp();
  row4[lane] = reinterpret_cast<const float4*>(cols)[lane];
}

}  // namespace

extern "C" {

// levels (B,L,H,W) f32; uv (B,K,2) f32; level (B,K) i32, or i64 with
// level64; sigma (B,K) f32; mask (B,K) bool; out (B,K,128) f32, 16-byte
// aligned.  Hp/Wp are the
// padded sizes the sampling is defined on; kpb (1..16) keypoints per block.
// Returns cudaGetLastError().
int dsc_describe_upright(const float* levels, const float* uv, const void* level,
                         bool level64, const float* sigma, const uint8_t* mask, float* out,
                         int B, int L, int H, int W, int Hp, int Wp, int K,
                         float xmax, float ymax, int kpb, void* stream) {
  if (kpb < 1 || kpb > MAX_KPB) return cudaErrorInvalidValue;
  const int n_kp = B * K;
  if (n_kp == 0) return cudaSuccess;
  const size_t smem = (size_t)kpb * WARP_FLOATS * sizeof(float);
  describe_kernel<<<(n_kp + kpb - 1) / kpb, 32 * kpb, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      levels, uv, level, level64, sigma, mask, out, n_kp, L, H, W, Hp, Wp, K, xmax, ymax);
  return cudaGetLastError();
}

const char* dsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
