// K1: the whole class-constrained 2D ICP fit loop, one CUDA block per robot.
//
// Replaces: slam_tpu/ops/icp_pallas.py `_icp_kernel_planes` -> `_icp_core`
// (the resident Pallas kernel behind `_icp_batched_planes` and
// `fused_register`).
//
// What bounds it on the card: arithmetic and shared-memory reads, not device
// memory. Per fit iteration a robot evaluates S x C squared distances twice
// (row-min pass, then tie pass); the operands are 3 x (S + C) floats
// (10.8 KB at S = 384, C = 512), read from device memory once per call. The
// TPU kernel kept an (S, C) tile in VMEM; here no tile exists at all.
//
// What the design does about it:
// - scene and model planes are staged into shared memory once and stay there
//   for every iteration; all threads of a warp read the same model point at
//   the same time, so the reads are broadcasts without bank conflicts;
// - each thread owns scene rows and makes one pass over the model for the
//   row minimum and, only for inlier rows, a second pass for the tie count
//   and tie sums: two passes instead of the TPU's three row-sum passes;
// - pairs of different class are skipped instead of penalised (their
//   BIG + d2 is exactly BIG in f32 and can never be a participating row's
//   minimum, because participation requires > 3 model points of the class);
// - the ten Kabsch moments reduce across the block with warp shuffles and a
//   small shared array; one thread updates the pose and the convergence flag,
//   which the whole block reads, so the loop exit is uniform per block;
// - 128 threads and ~11 KB of shared memory per block let 16 blocks share an
//   SM, so a 1024-robot fleet is resident on 132 SMs in one wave.
//
// Semantics follow `_icp_core` exactly: the ok gate, class participation only
// where the model holds > 3 points of the class, `d2 <= rowmin` ties averaged,
// the 1e-12 / 1e-24 floors, the no-correspondence freeze with delta = -1, the
// initial carry (ncorr 0, mres 0, delta inf) and the final ok-select of the
// pose. The tie test compares d2 for exact equality, so both passes compute
// d2 with the same explicitly rounded function (and the file is built with
// -fmad=false), making them agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "icp_common.cuh"

namespace {

using slam_icp::sqdist;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMoments = 10;

template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, float* total) {
  slam_icp::block_sum<kThreads, N>(v, red, total);
}

__global__ void __launch_bounds__(kThreads)
icp_fused_planes_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                        const float* __restrict__ sc, const float* __restrict__ mx,
                        const float* __restrict__ my, const float* __restrict__ mc,
                        const float* __restrict__ init4, float* __restrict__ out,
                        int S, int C, int max_iter, float inlier_dist,
                        float min_delta, int min_scene) {
  extern __shared__ float smem[];
  float* s_mx = smem;
  float* s_my = s_mx + C;
  float* s_mc = s_my + C;
  float* s_sx = s_mc + C;
  float* s_sy = s_sx + S;
  float* s_sc = s_sy + S;
  __shared__ float red[kWarps * kMoments];
  __shared__ float tot[kMoments];
  // carry: tx, ty, cos, sin, converged, ncorr, mres, delta
  __shared__ float carry[8];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t so = (size_t)b * S;
  const size_t mo = (size_t)b * C;

  float cnt[3] = {0.f, 0.f, 0.f};  // model GA, model NGA, valid scene
  for (int c = tid; c < C; c += kThreads) {
    const float m = mc[mo + c];
    s_mx[c] = mx[mo + c];
    s_my[c] = my[mo + c];
    s_mc[c] = m;
    cnt[0] += (m == 1.f) ? 1.f : 0.f;
    cnt[1] += (m == 0.f) ? 1.f : 0.f;
  }
  for (int r = tid; r < S; r += kThreads) {
    const float s = sc[so + r];
    s_sx[r] = sx[so + r];
    s_sy[r] = sy[so + r];
    s_sc[r] = s;
    cnt[2] += (s >= 0.f) ? 1.f : 0.f;
  }
  block_sum<3>(cnt, red, tot);  // ends in __syncthreads: smem planes are ready
  const float m_ga = tot[0];
  const float m_nga = tot[1];
  const bool ok = (tot[2] >= (float)min_scene) && (m_ga + m_nga >= 5.f);
  const bool ga_on = m_ga > 3.f;
  const bool nga_on = m_nga > 3.f;

  const float i_tx = init4[4 * b + 0];
  const float i_ty = init4[4 * b + 1];
  const float i_c = init4[4 * b + 2];
  const float i_s = init4[4 * b + 3];
  if (tid == 0) {
    carry[0] = i_tx;
    carry[1] = i_ty;
    carry[2] = i_c;
    carry[3] = i_s;
    carry[4] = ok ? 0.f : 1.f;
    carry[5] = 0.f;
    carry[6] = 0.f;
    carry[7] = INFINITY;
  }
  __syncthreads();

  for (int it = 0; it < max_iter && carry[4] == 0.f; ++it) {
    const float tx = carry[0], ty = carry[1], cth = carry[2], sth = carry[3];
    float acc[kMoments];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) acc[k] = 0.f;

    for (int r = tid; r < S; r += kThreads) {
      const float cls = s_sc[r];
      const bool part = cls >= 0.f && (cls == 1.f ? ga_on : nga_on);
      if (!part) continue;
      const float px = s_sx[r], py = s_sy[r];
      float qx, qy;
      slam_icp::transform(px, py, tx, ty, cth, sth, qx, qy);
      float rowmin = INFINITY;
      for (int c = 0; c < C; ++c) {
        if (s_mc[c] == cls) rowmin = fminf(rowmin, sqdist(qx, qy, s_mx[c], s_my[c]));
      }
      if (!(rowmin < inlier_dist)) continue;
      float nt = 0.f, tsx = 0.f, tsy = 0.f;
      for (int c = 0; c < C; ++c) {
        if (s_mc[c] == cls && sqdist(qx, qy, s_mx[c], s_my[c]) <= rowmin) {
          nt += 1.f;
          tsx += s_mx[c];
          tsy += s_my[c];
        }
      }
      const float inv_nt = 1.f / fmaxf(nt, 1.f);
      const float ux = tsx * inv_nt;
      const float uy = tsy * inv_nt;
      acc[0] += 1.f;
      acc[1] += qx;
      acc[2] += qy;
      acc[3] += ux;
      acc[4] += uy;
      acc[5] += qx * ux;
      acc[6] += qx * uy;
      acc[7] += qy * ux;
      acc[8] += qy * uy;
      acc[9] += rowmin;
    }
    block_sum<kMoments>(acc, red, tot);

    if (tid == 0) slam_icp::pose_update(tot, carry, min_delta);
    __syncthreads();
  }

  if (tid == 0) {
    float* o = out + 8 * (size_t)b;
    o[0] = ok ? carry[0] : i_tx;
    o[1] = ok ? carry[1] : i_ty;
    o[2] = ok ? carry[2] : i_c;
    o[3] = ok ? carry[3] : i_s;
    o[4] = ok ? 1.f : 0.f;
    o[5] = carry[5];
    o[6] = carry[6];
    o[7] = carry[7];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Planes are contiguous (B, S) and
// (B, C) f32; init4 is (B, 4) [x, y, cos, sin]; out is (B, 8)
// [tx, ty, cos, sin, ok, ncorr, mres, delta]. Returns cudaGetLastError().
extern "C" int slam_icp_fused_planes(const float* sx, const float* sy, const float* sc,
                                     const float* mx, const float* my, const float* mc,
                                     const float* init4, float* out, int B, int S, int C,
                                     int max_iter, float inlier_dist, float min_delta,
                                     int min_scene, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)3 * (S + C) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        icp_fused_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  icp_fused_planes_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      sx, sy, sc, mx, my, mc, init4, out, S, C, max_iter, inlier_dist, min_delta, min_scene);
  return (int)cudaGetLastError();
}
