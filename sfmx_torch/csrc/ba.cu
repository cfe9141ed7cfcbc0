// Bundle-adjustment kernels K6, K7 and K8 for Hopper (sm_90a), the CUDA
// counterparts of the three Pallas TPU kernels in sfmx/kernels/segsum.py:
//
//   K6  ba_schur_matvec   replaces schur_cross_matvec  (_matvec_kernel)
//   K7  ba_assemble       replaces ba_assemble_fused   (_assemble_kernel)
//   K8  ba_cost           replaces ba_cost_fused       (_cost_kernel)
//
// Layout (shared with the TPU kernels, without their lane/sublane padding):
// observations sorted by point sit in (tp, P) slots, the point axis fastest.
// `camp[j*P + p]` is the camera of slot j of point p, `cnt[p]` the number of
// real slots of p (slots j >= cnt[p] are pads: W = 0, weight 0).  W blocks
// live as `Wp[(j*18 + a*3 + k)*P + p]`, written once per LM iteration by K7
// in exactly the layout K6 streams.  Per-camera vectors are (rows, C) with
// the camera axis fastest, per-point vectors (rows, P).
//
// What bounds them on this card: bytes.  One CG matvec touches O*72 B of W
// and does 72 FLOP per observation; the assembly does a few hundred FLOP
// per observation against ~100 B.  All three sit far below the f32 ridge,
// so the design is about reading W once, coalesced, and keeping every
// intermediate in registers.
//
// Design:
//   * The point side of all three: a point's slots are SPLIT ACROSS
//     THREADS.  A block is 32 adjacent points (x, so every row of W, uvw and
//     camp coalesces) by G slot groups (y); thread (x, y) takes slots y,
//     y+G, ...  The G partial sums of a point (K6: y = W^T x; K7: V, b_p and
//     the cost; K8: each candidate's cost) meet in shared memory and are
//     added in group order, so tp dependent gather rounds become tp / G and
//     the grid grows G-fold on small problems (a thread walking its point's
//     slots alone ran at the latency of the longest track on a few SMs).
//     The camera of a slot is read by index from the small per-camera
//     table (K8 stages its candidates' tables in shared memory where they
//     fit, K6 and K7 read theirs through the cache): the TPU kernels' one-hot
//     matmuls, their hi/lo bf16 split and their per-tile camera window have
//     no counterpart here.
//   * Camera side (K6: z = sum W vy, K7: U and b_c): the TPU kernels
//     accumulate across a sequential grid; CUDA blocks run in no order.
//     Chosen here: a SECOND, CAMERA-MAJOR launch and no atomics.  Why not
//     f32 atomicAdd: 6 (K6) or 42 (K7) atomics per observation onto a few
//     thousand addresses serialize, and their order changes from run to
//     run, so two solves of one problem would differ in the last bits and,
//     through the accept/reject of LM steps, sometimes visibly.
//       K6: the block that just computed vy for its 32 points walks its
//     slots once more (W is still in L1/L2, read coalesced) and writes each
//     slot's 6 products W vy to the slot's place in a camera-major scratch
//     (6, n_dense); `slot_pos` holds that place for every dense slot.  The
//     second launch gives each camera to one block, which STREAMS its
//     contiguous run of the scratch and reduces it with a fixed shuffle +
//     shared-memory tree: W is never gathered at stride P.
//       K7: the same pattern.  While the point pass has a slot's Jacobians
//     in registers it writes the slot's 27 camera-side terms (U's upper
//     triangle, b_c) to its row `slot_pos` of a camera-major scratch
//     (n_dense, 28: one padding float, so a row is 7 aligned 16-byte
//     stores); the second launch gives each camera to one block, whose
//     threads stream the camera's contiguous rows, 18 row phases by 27 terms
//     (every load coalesced), and add the phases in order.
//     Every result of these kernels is bit-reproducible.
//   * K7 and K8 share `project_residual` and `huber`, so the cost a trial
//     step is compared with comes from the same arithmetic as the cost of
//     the accepted state.
//   * No fast-math: 1/z, sqrt and the Huber branch feed a cost comparison.
#include <cuda_runtime.h>

namespace {

constexpr int CAM_THREADS = 128;  // K6's camera pass: threads per camera block
constexpr int MAX_NC = 16;        // K8: parameter candidates per launch

struct Cam {
  float r[9], t[3], fx, fy, cx, cy, k1, k2, k3;
};

// cam19: (19, C) rows 0-8 R row-major, 9-11 t, 12-18 fx fy cx cy k1 k2 k3
__device__ __forceinline__ Cam load_cam(const float* __restrict__ cam19, int C, int c) {
  Cam m;
#pragma unroll
  for (int i = 0; i < 9; ++i) m.r[i] = cam19[i * C + c];
#pragma unroll
  for (int i = 0; i < 3; ++i) m.t[i] = cam19[(9 + i) * C + c];
  m.fx = cam19[12 * C + c];
  m.fy = cam19[13 * C + c];
  m.cx = cam19[14 * C + c];
  m.cy = cam19[15 * C + c];
  m.k1 = cam19[16 * C + c];
  m.k2 = cam19[17 * C + c];
  m.k3 = cam19[18 * C + c];
  return m;
}

struct Proj {
  float ru, rv;                     // focal-normalized residual
  float fm, fd, fp, iz, xn, yn;     // intermediates the Jacobians need
  float s0, s1, s2;                 // R X
};

__device__ __forceinline__ Proj project_residual(const Cam& m, float x0, float x1, float x2,
                                                 float u, float v) {
  Proj q;
  q.fm = 0.5f * (m.fx + m.fy);
  q.s0 = m.r[0] * x0 + m.r[1] * x1 + m.r[2] * x2;
  q.s1 = m.r[3] * x0 + m.r[4] * x1 + m.r[5] * x2;
  q.s2 = m.r[6] * x0 + m.r[7] * x1 + m.r[8] * x2;
  const float xc = q.s0 + m.t[0], yc = q.s1 + m.t[1], zc = q.s2 + m.t[2];
  const float zs = fabsf(zc) < 1e-9f ? 1e-9f : zc;
  q.iz = 1.0f / zs;
  q.xn = xc * q.iz;
  q.yn = yc * q.iz;
  const float r2 = q.xn * q.xn + q.yn * q.yn;
  q.fd = 1.0f + r2 * (m.k1 + r2 * (m.k2 + r2 * m.k3));
  q.fp = m.k1 + r2 * (2.0f * m.k2 + 3.0f * m.k3 * r2);
  q.ru = (m.fx * (q.xn * q.fd) + m.cx - u) / q.fm;
  q.rv = (m.fy * (q.yn * q.fd) + m.cy - v) / q.fm;
  return q;
}

// Huber loss of the residual norm: rho and the IRLS weight.
__device__ __forceinline__ void huber(float ru, float rv, float delta, float& rho, float& wh) {
  const float r2 = ru * ru + rv * rv;
  const float rn = sqrtf(fmaxf(r2, 1e-20f));
  const bool small = rn <= delta;
  rho = small ? r2 : delta * (2.0f * rn - delta);
  wh = small ? 1.0f : delta / rn;
}

// Analytic Jacobian rows of (ru, rv): Ju/Jv wrt the camera tangent (w, t),
// Pu/Pv wrt the point.
__device__ __forceinline__ void jacobians(const Cam& m, const Proj& q, float* Ju, float* Jv,
                                          float* Pu, float* Pv) {
  const float gx = m.fx / q.fm, gy = m.fy / q.fm;
  const float A00 = gx * (q.fd + 2.0f * q.xn * q.xn * q.fp);
  const float A01 = gx * (2.0f * q.xn * q.yn * q.fp);
  const float A10 = gy * (2.0f * q.xn * q.yn * q.fp);
  const float A11 = gy * (q.fd + 2.0f * q.yn * q.yn * q.fp);
  const float B00 = A00 * q.iz, B01 = A01 * q.iz;
  const float B02 = -(A00 * q.xn + A01 * q.yn) * q.iz;
  const float B10 = A10 * q.iz, B11 = A11 * q.iz;
  const float B12 = -(A10 * q.xn + A11 * q.yn) * q.iz;
  Ju[0] = -B01 * q.s2 + B02 * q.s1;
  Ju[1] = B00 * q.s2 - B02 * q.s0;
  Ju[2] = -B00 * q.s1 + B01 * q.s0;
  Ju[3] = B00;
  Ju[4] = B01;
  Ju[5] = B02;
  Jv[0] = -B11 * q.s2 + B12 * q.s1;
  Jv[1] = B10 * q.s2 - B12 * q.s0;
  Jv[2] = -B10 * q.s1 + B11 * q.s0;
  Jv[3] = B10;
  Jv[4] = B11;
  Jv[5] = B12;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Pu[k] = B00 * m.r[k] + B01 * m.r[3 + k] + B02 * m.r[6 + k];
    Pv[k] = B10 * m.r[k] + B11 * m.r[3 + k] + B12 * m.r[6 + k];
  }
}

// First half of a fixed-order sum of N per-thread values over a CAM_THREADS
// block: a shuffle tree within each warp leaves each warp's partials in
// smem (warps, N); after the barrier, thread i < N adds column i in warp
// order.
template <int N>
__device__ __forceinline__ void block_sum(const float* acc, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) smem[warp * N + i] = v;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K6: y = sum_slots W^T x[cam] + bias; vy = Vinv y; zo[slot] = W vy  (point pass)
//     z[cam] = sum of the camera's run of zo                          (camera pass)
// ---------------------------------------------------------------------------
// Replaces schur_cross_matvec (sfmx/kernels/segsum.py, _matvec_kernel).
// Bound by bytes: O*72 B of W plus O*4 B of camp against 72 FLOP per
// observation.  On the problems BA really solves (10^4-10^5 observations)
// the time is latency, not bytes: the point pass cuts the dependent rounds
// per thread to tp / G, and the camera pass reads a stream.

constexpr int PT_LANES = 32;      // points per block of the K6 point pass

__global__ void __launch_bounds__(PT_LANES * 32)
matvec_point_kernel(const float* __restrict__ Wp, const int* __restrict__ camp,
                    const int* __restrict__ cnt, const int* __restrict__ slot_pos,
                    const float* __restrict__ vinv9, const float* __restrict__ x6,
                    const float* __restrict__ bias3, float* __restrict__ vy3,
                    float* __restrict__ zo, int tp, int P, int C, int n_dense) {
  extern __shared__ float part[];           // (G, 3, 32) partial y, then (3, 32) vy
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int p = blockIdx.x * PT_LANES + lane;
  const int n = p < P ? min(cnt[p], tp) : 0;
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f;
  for (int j = g; j < n; j += G) {
    const int c = camp[(size_t)j * P + p];
    const float* w = Wp + (size_t)j * 18 * P + p;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float xa = x6[a * C + c];
      y0 += w[(size_t)(a * 3 + 0) * P] * xa;
      y1 += w[(size_t)(a * 3 + 1) * P] * xa;
      y2 += w[(size_t)(a * 3 + 2) * P] * xa;
    }
  }
  part[(g * 3 + 0) * PT_LANES + lane] = y0;
  part[(g * 3 + 1) * PT_LANES + lane] = y1;
  part[(g * 3 + 2) * PT_LANES + lane] = y2;
  __syncthreads();
  float* vys = part + G * 3 * PT_LANES;
  if (g == 0 && p < P) {
    // the bias first, then the groups in order: a fixed summation order
    y0 = y1 = y2 = 0.0f;
    if (bias3 != nullptr) {
      y0 = bias3[p];
      y1 = bias3[P + p];
      y2 = bias3[2 * (size_t)P + p];
    }
    for (int q = 0; q < G; ++q) {
      y0 += part[(q * 3 + 0) * PT_LANES + lane];
      y1 += part[(q * 3 + 1) * PT_LANES + lane];
      y2 += part[(q * 3 + 2) * PT_LANES + lane];
    }
    float vi[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) vi[i] = vinv9[(size_t)i * P + p];
    const float v0 = vi[0] * y0 + vi[1] * y1 + vi[2] * y2;
    const float v1 = vi[3] * y0 + vi[4] * y1 + vi[5] * y2;
    const float v2 = vi[6] * y0 + vi[7] * y1 + vi[8] * y2;
    vy3[p] = v0;
    vy3[P + p] = v1;
    vy3[2 * (size_t)P + p] = v2;
    vys[lane] = v0;
    vys[PT_LANES + lane] = v1;
    vys[2 * PT_LANES + lane] = v2;
  }
  __syncthreads();
  const float v0 = vys[lane], v1 = vys[PT_LANES + lane], v2 = vys[2 * PT_LANES + lane];
  for (int j = g; j < n; j += G) {
    const int k = slot_pos[(size_t)j * P + p];
    const float* w = Wp + (size_t)j * 18 * P + p;
#pragma unroll
    for (int a = 0; a < 6; ++a)
      zo[(size_t)a * n_dense + k] = w[(size_t)(a * 3 + 0) * P] * v0 +
                                    w[(size_t)(a * 3 + 1) * P] * v1 +
                                    w[(size_t)(a * 3 + 2) * P] * v2;
  }
}

__global__ void __launch_bounds__(CAM_THREADS)
matvec_cam_kernel(const float* __restrict__ zo, const int* __restrict__ cam_ptr,
                  float* __restrict__ z6, int n_dense, int C) {
  __shared__ float smem[(CAM_THREADS / 32) * 6];
  const int c = blockIdx.x;
  const int beg = cam_ptr[c], end = cam_ptr[c + 1];
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = beg + threadIdx.x; k < end; k += CAM_THREADS) {
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[a] += zo[(size_t)a * n_dense + k];
  }
  block_sum<6>(acc, smem);
  if (threadIdx.x < 6) {
    float v = 0.0f;
#pragma unroll
    for (int wq = 0; wq < CAM_THREADS / 32; ++wq) v += smem[wq * 6 + threadIdx.x];
    z6[threadIdx.x * C + c] = v;
  }
}

// ---------------------------------------------------------------------------
// K7: residuals, Jacobians, Huber weights -> Wp, per-point V9 / b_p / cost,
//     each slot's camera-side terms (point pass); per-camera U (36) and b_c
//     (6) from the camera's run of those terms (camera pass)
// ---------------------------------------------------------------------------
// Replaces ba_assemble_fused (segsum.py, _assemble_kernel).  Bound by bytes:
// it reads O*16 B (uvw, camp) and writes O*72 B of W, against ~350 FLOP per
// observation.  On the problems BA solves the time was latency: a thread per
// point walked up to tp = 64 dependent slots (camp -> camera -> projection
// -> Jacobians -> 18 stores) on 18 blocks at the build's 2,290 points, and a
// camera block recomputed every observation's projection behind a dependent
// gather.  Now the point pass splits a point's slots over G groups (K8's
// shape, G from the layout alone, so every call of a solve sums in one
// order), reads the camera table through the cache (staging it in shared
// memory gained nothing at the build's 96 cameras and lost at ba-512), and
// writes each slot's 27 camera-side terms once, which the camera pass
// streams.  No atomics: bit-reproducible.

constexpr int ASM_LANES = 32;       // points per block of the K7 point pass
constexpr int ASM_MAX_GROUPS = 16;  // slot groups (warps) per block of the K7 point pass
constexpr int NV = 13;              // point rows: V9, b_p, cost
constexpr int NCAM = 27;            // camera-side terms of a slot: U's upper triangle, b_c
constexpr int ZC_STRIDE = 28;       // floats a scratch row: 7 aligned float4 stores a slot
constexpr int ASM_CAM_THREADS = 512;
constexpr int ASM_CAM_PHASES = ASM_CAM_THREADS / ZC_STRIDE;   // 18 rows in flight a block

__global__ void __launch_bounds__(ASM_LANES * ASM_MAX_GROUPS)
assemble_point_kernel(const float* __restrict__ cam19, const int* __restrict__ camp,
                      const int* __restrict__ cnt, const int* __restrict__ slot_pos,
                      const float* __restrict__ uvw, const float* __restrict__ x3, float delta,
                      float* __restrict__ v13, float* __restrict__ Wp, float* __restrict__ zc,
                      int tp, int P, int C) {
  __shared__ float part[ASM_MAX_GROUPS * NV * ASM_LANES];     // (G, 13, 32) partials
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int p = blockIdx.x * ASM_LANES + lane;
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
  if (p < P) {
    const float x0 = x3[p], x1 = x3[P + p], x2 = x3[2 * (size_t)P + p];
    const int n = min(cnt[p], tp);
    for (int j = g; j < tp; j += G) {
      float* w = Wp + (size_t)j * 18 * P + p;
      if (j >= n) {   // pad slots carry W = 0 (K6 never reads them, the layout's contract does)
#pragma unroll
        for (int i = 0; i < 18; ++i) w[(size_t)i * P] = 0.0f;
        continue;
      }
      const Cam m = load_cam(cam19, C, camp[(size_t)j * P + p]);
      const float u = uvw[(size_t)(3 * j) * P + p];
      const float v = uvw[(size_t)(3 * j + 1) * P + p];
      const float wv = uvw[(size_t)(3 * j + 2) * P + p];
      const Proj q = project_residual(m, x0, x1, x2, u, v);
      float rho, wh;
      huber(q.ru, q.rv, delta, rho, wh);
      acc[12] += 0.5f * rho * wv;
      wh *= wv;
      float Ju[6], Jv[6], Pu[3], Pv[3];
      jacobians(m, q, Ju, Jv, Pu, Pv);
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          w[(size_t)(a * 3 + k) * P] = wh * (Ju[a] * Pu[k] + Jv[a] * Pv[k]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int l = 0; l < 3; ++l) acc[k * 3 + l] += wh * (Pu[k] * Pu[l] + Pv[k] * Pv[l]);
        acc[9 + k] -= wh * (Pu[k] * q.ru + Pv[k] * q.rv);
      }
      float z[ZC_STRIDE];
      int i = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) z[i++] = wh * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
#pragma unroll
      for (int a = 0; a < 6; ++a) z[21 + a] = -wh * (Ju[a] * q.ru + Jv[a] * q.rv);
      z[NCAM] = 0.0f;
      float4* zr = reinterpret_cast<float4*>(zc + (size_t)slot_pos[(size_t)j * P + p] * ZC_STRIDE);
#pragma unroll
      for (int v4 = 0; v4 < ZC_STRIDE / 4; ++v4)
        zr[v4] = make_float4(z[4 * v4], z[4 * v4 + 1], z[4 * v4 + 2], z[4 * v4 + 3]);
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) part[(g * NV + i) * ASM_LANES + lane] = acc[i];
  __syncthreads();
  if (p >= P) return;
  // warp g sums rows g, g+G, ...: the point's groups in order
  for (int i = g; i < NV; i += G) {
    float s = part[i * ASM_LANES + lane];
    for (int q = 1; q < G; ++q) s += part[(q * NV + i) * ASM_LANES + lane];
    v13[(size_t)i * P + p] = s;
  }
}

__global__ void __launch_bounds__(ASM_CAM_THREADS)
assemble_cam_kernel(const float* __restrict__ zc, const int* __restrict__ cam_ptr,
                    float* __restrict__ U36, float* __restrict__ bc6) {
  __shared__ float part[ASM_CAM_PHASES * ZC_STRIDE];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int beg = cam_ptr[c], end = cam_ptr[c + 1];
  const int phase = tid / ZC_STRIDE, term = tid - phase * ZC_STRIDE;
  if (phase < ASM_CAM_PHASES && term < NCAM) {
    // thread (phase, term) adds term `term` of rows beg + phase, + 18, ... in
    // order: the block's loads of one step are 18 whole contiguous rows
    float acc = 0.0f;
#pragma unroll 4
    for (int k = beg + phase; k < end; k += ASM_CAM_PHASES) acc += zc[(size_t)k * ZC_STRIDE + term];
    part[phase * ZC_STRIDE + term] = acc;
  }
  __syncthreads();
  if (tid < NCAM) {
    float v = part[tid];
#pragma unroll
    for (int ph = 1; ph < ASM_CAM_PHASES; ++ph) v += part[ph * ZC_STRIDE + tid];
    if (tid >= 21) {
      bc6[(size_t)c * 6 + (tid - 21)] = v;
    } else {
      int a = 0, i = tid;        // upper-triangle index -> (a, b)
      while (i >= 6 - a) {
        i -= 6 - a;
        ++a;
      }
      const int b = a + i;
      U36[(size_t)c * 36 + a * 6 + b] = v;
      U36[(size_t)c * 36 + b * 6 + a] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K8: robust cost of nc parameter candidates in one pass over the slots;
//     the last block to finish adds the blocks' partials in block order
// ---------------------------------------------------------------------------
// Replaces ba_cost_fused (segsum.py, _cost_kernel).  Bound by bytes (O*16 B
// read once for all candidates, ~60 FLOP per observation and candidate),
// but on the problems BA solves the time is latency: a thread per point
// walked up to tp slots, each a dependent chain camp -> camera -> projection
// -> Huber for every candidate.  Now a block is 32 adjacent points (x, so
// every camp / uvw row still coalesces) by G slot groups (y); thread (x, y)
// reads each of slots y, y+G, ... once and evaluates all nc candidates from
// it.  The candidates' camera tables are staged in shared memory when they
// fit the wrapper's limit, else read through the read-only cache.  The G
// partial costs of a point meet in shared memory and are added in group
// order, the block's 32 points by a fixed shuffle tree.  Blocks run in no
// order, so each writes its partials to a scratch and takes a ticket (an
// integer atomic); the block that takes the last one adds all blocks'
// partials with a fixed strided walk and tree, and resets the ticket for
// the next launch.  One launch, and no float atomics: the cost is the same
// bits from run to run, and a candidate's
// cost does not depend on nc or on its place among the candidates (its
// arithmetic and its order of sums are its own), so the LM loop compares
// costs from nc = 1 and nc = 4 launches on equal terms.

constexpr int CO_LANES = 32;      // points per block of the K8 point pass
constexpr int CO_MAX_GROUPS = 16; // slot groups (warps) per block of the K8 point pass

__device__ __forceinline__ float warp_tree_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// NCM candidates at most (the unrolled copies); STAGE: camera tables in shared memory
template <int NCM, bool STAGE>
__global__ void __launch_bounds__(CO_LANES * CO_MAX_GROUPS)
cost_point_kernel(const float* __restrict__ cam19s, const int* __restrict__ camp,
                  const int* __restrict__ cnt, const float* __restrict__ uvw,
                  const float* __restrict__ x3s, float delta, float* __restrict__ part_out,
                  unsigned int* __restrict__ ticket, float* __restrict__ cost_out,
                  int tp, int P, int C, int nc) {
  extern __shared__ float sm[];     // [19*nc*C camera tables if STAGE] [(G, nc, 32) partials]
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int p = blockIdx.x * CO_LANES + lane;
  const float* cams = cam19s;
  float* part = sm;
  if (STAGE) {
    const int n_cam = 19 * nc * C;
    for (int k = g * CO_LANES + lane; k < n_cam; k += G * CO_LANES) sm[k] = cam19s[k];
    cams = sm;
    part = sm + n_cam;
    __syncthreads();
  }
  const int n = p < P ? min(cnt[p], tp) : 0;
  float x[NCM][3], cost[NCM];
#pragma unroll
  for (int i = 0; i < NCM; ++i) {
    cost[i] = 0.0f;
    x[i][0] = x[i][1] = x[i][2] = 0.0f;
    if (i < nc && p < P) {
      const float* xp = x3s + (size_t)i * 3 * P + p;
      x[i][0] = xp[0];
      x[i][1] = xp[P];
      x[i][2] = xp[2 * (size_t)P];
    }
  }
  for (int j = g; j < n; j += G) {
    const int c = camp[(size_t)j * P + p];
    const float u = uvw[(size_t)(3 * j) * P + p];
    const float v = uvw[(size_t)(3 * j + 1) * P + p];
    const float wv = uvw[(size_t)(3 * j + 2) * P + p];
#pragma unroll
    for (int i = 0; i < NCM; ++i) {
      if (i < nc) {
        const Cam m = load_cam(cams + (size_t)i * 19 * C, C, c);
        const Proj q = project_residual(m, x[i][0], x[i][1], x[i][2], u, v);
        float rho, wh;
        huber(q.ru, q.rv, delta, rho, wh);
        cost[i] += 0.5f * rho * wv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NCM; ++i)
    if (i < nc) part[(g * nc + i) * CO_LANES + lane] = cost[i];
  __syncthreads();
  // warp g sums candidates g, g+G, ...: its point's groups in order, then the 32 points
  for (int i = g; i < nc; i += G) {
    float s = part[i * CO_LANES + lane];
    for (int q = 1; q < G; ++q) s += part[(q * nc + i) * CO_LANES + lane];
    s = warp_tree_sum(s);
    if (lane == 0) {
      part_out[(size_t)i * gridDim.x + blockIdx.x] = s;
      __threadfence();    // the partial reaches device memory before the ticket is taken
    }
  }
  __syncthreads();
  __shared__ bool last;
  if (lane == 0 && g == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: warp g sums candidates g, g+G, ...; lane l adds blocks
  // l, l+32, ... in order (read past L1: other SMs wrote them), then the tree
  const int nb = gridDim.x;
  for (int i = g; i < nc; i += G) {
    float s = 0.0f;
#pragma unroll 4
    for (int b = lane; b < nb; b += 32) s += __ldcg(part_out + (size_t)i * nb + b);
    s = warp_tree_sum(s);
    if (lane == 0) cost_out[i] = s;
  }
  if (lane == 0 && g == 0) *ticket = 0u;
}

template <int NCM, bool STAGE>
cudaError_t launch_cost(const float* cam19s, const int* camp, const int* cnt, const float* uvw,
                        const float* x3s, float delta, float* part, unsigned int* ticket,
                        float* out, int tp, int P, int C, int nc, int groups, cudaStream_t st) {
  const size_t smem = ((STAGE ? (size_t)19 * nc * C : 0) + (size_t)groups * nc * CO_LANES) *
                      sizeof(float);
  static size_t allowed = 48 * 1024;  // dynamic shared memory above 48 KB needs the attribute
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        cost_point_kernel<NCM, STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();             // a refused size is reported here, not by a later launch
      return err;
    }
    allowed = smem;
  }
  cost_point_kernel<NCM, STAGE><<<(P + CO_LANES - 1) / CO_LANES, dim3(CO_LANES, groups), smem,
                                  st>>>(cam19s, camp, cnt, uvw, x3s, delta, part, ticket, out, tp,
                                        P, C, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6.  Wp (tp*18, P) f32, camp (tp, P) i32, cnt (P,) i32, slot_pos (tp, P)
// i32 place of each dense slot in camera order (pads unread), vinv9 (9, P),
// x6 (6, C), bias3 (3, P) or null, cam_ptr (C+1,) i32 offsets of each
// camera's run, zo (6, n_dense) scratch.  `groups` (1..32) is the number of
// threads that share a point's slots.  Writes vy3 (3, P), z6 (6, C).
// Returns cudaGetLastError() after the two launches.
int ba_schur_matvec(const float* Wp, const int* camp, const int* cnt, const int* slot_pos,
                    const float* vinv9, const float* x6, const float* bias3,
                    const int* cam_ptr, float* zo, float* vy3, float* z6, int tp, int P, int C,
                    int n_dense, int groups, void* stream) {
  if (tp <= 0 || P <= 0 || C <= 0 || n_dense < 0 || groups < 1 || groups > 32)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(PT_LANES, groups);
  const size_t smem = (size_t)(groups + 1) * 3 * PT_LANES * sizeof(float);
  matvec_point_kernel<<<(P + PT_LANES - 1) / PT_LANES, block, smem, st>>>(
      Wp, camp, cnt, slot_pos, vinv9, x6, bias3, vy3, zo, tp, P, C, n_dense);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  matvec_cam_kernel<<<C, CAM_THREADS, 0, st>>>(zo, cam_ptr, z6, n_dense, C);
  return cudaGetLastError();
}

// K7.  cam19 (19, C), camp (tp, P), cnt (P,), slot_pos (tp, P) i32 place of
// each dense slot in camera order, uvw (tp*3, P) rows [u, v, w_valid] per
// slot, x3 (3, P), cam_ptr (C+1,) offsets of each camera's run, zc (n_dense,
// 28) scratch (16-byte aligned).  Writes v13 (13, P) rows 0-8 V9, 9-11 b_p, 12 cost partial; Wp
// (tp*18, P); U36 (C, 36); bc6 (C, 6).  `groups` (1..16) threads share a
// point's slots.  Returns cudaGetLastError() after the two launches.
int ba_assemble(const float* cam19, const int* camp, const int* cnt, const int* slot_pos,
                const float* uvw, const float* x3, float delta, const int* cam_ptr, float* zc,
                float* v13, float* Wp, float* U36, float* bc6, int tp, int P, int C, int groups,
                void* stream) {
  if (tp <= 0 || P <= 0 || C <= 0 || groups < 1 || groups > ASM_MAX_GROUPS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  assemble_point_kernel<<<(P + ASM_LANES - 1) / ASM_LANES, dim3(ASM_LANES, groups), 0, st>>>(
      cam19, camp, cnt, slot_pos, uvw, x3, delta, v13, Wp, zc, tp, P, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  assemble_cam_kernel<<<C, ASM_CAM_THREADS, 0, st>>>(zc, cam_ptr, U36, bc6);
  return cudaGetLastError();
}

// K8.  cam19s (19*nc, C), x3s (3*nc, P).  Writes out (nc,).  part is a
// scratch of nc * ceil(P/32) floats, ticket one zeroed counter that the
// launch leaves at zero (calls that share them must share a stream).
// `groups` (1..16) threads share a point's slots; `stage` puts the camera
// tables in shared memory.  Returns cudaGetLastError().
int ba_cost(const float* cam19s, const int* camp, const int* cnt, const float* uvw,
            const float* x3s, float delta, float* out, float* part, unsigned int* ticket,
            int tp, int P, int C, int nc, int groups, bool stage, void* stream) {
  if (tp <= 0 || P <= 0 || C <= 0 || nc <= 0 || nc > MAX_NC || groups < 1 ||
      groups > CO_MAX_GROUPS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc <= 4)
    return stage ? launch_cost<4, true>(cam19s, camp, cnt, uvw, x3s, delta, part, ticket, out, tp,
                                        P, C, nc, groups, st)
                 : launch_cost<4, false>(cam19s, camp, cnt, uvw, x3s, delta, part, ticket, out,
                                         tp, P, C, nc, groups, st);
  return stage ? launch_cost<MAX_NC, true>(cam19s, camp, cnt, uvw, x3s, delta, part, ticket, out,
                                           tp, P, C, nc, groups, st)
               : launch_cost<MAX_NC, false>(cam19s, camp, cnt, uvw, x3s, delta, part, ticket,
                                            out, tp, P, C, nc, groups, st);
}

int ba_max_candidates() { return MAX_NC; }

const char* ba_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
