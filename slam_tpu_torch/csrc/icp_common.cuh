// Helpers shared by the fused-ICP kernels K1 (icp_fused.cu) and K3
// (icp_tiled.cu).
#pragma once

#include <cuda_runtime.h>

namespace slam_icp {

// Squared distance with every product and sum rounded on its own: the tie
// test compares two such values for exact equality, so every pass that
// computes d2 must round it the same way (the files are also built with
// -fmad=false).
__device__ __forceinline__ float sqdist(float qx, float qy, float mx, float my) {
  const float dx = __fsub_rn(qx, mx);
  const float dy = __fsub_rn(qy, my);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Scene point under the pose (tx, ty, cos, sin), rounded in the plain
// PyTorch version's order.
__device__ __forceinline__ void transform(float px, float py, float tx, float ty,
                                          float cth, float sth, float& qx, float& qy) {
  qx = __fadd_rn(__fsub_rn(__fmul_rn(cth, px), __fmul_rn(sth, py)), tx);
  qy = __fadd_rn(__fadd_rn(__fmul_rn(sth, px), __fmul_rn(cth, py)), ty);
}

// Sum v[0..N) over a block of kThreads threads, in a fixed order (warp
// shuffles, then the warps' sums in warp order); every thread gets the
// totals in `total`. `red` holds kThreads / 32 * N floats.
template <int kThreads, int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, float* total) {
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * N + k];
      total[k] = s;
    }
  }
  __syncthreads();
}

// One fit iteration's pose update from the ten Kabsch moment sums
// (W, sum qx, sum qy, sum ux, sum uy, sum qx ux, sum qx uy, sum qy ux,
// sum qy uy, sum w rowmin), as _icp_core computes it. carry is
// [tx, ty, cos, sin, converged, ncorr, mres, delta]; the caller runs it
// only while carry[4] == 0.
__device__ __forceinline__ void pose_update(const float* tot, float* carry, float min_delta) {
  const float tx = carry[0], ty = carry[1], cth = carry[2], sth = carry[3];
  const float W = tot[0];
  const float Ws = fmaxf(W, 1e-12f);
  const float mqx = tot[1] / Ws;
  const float mqy = tot[2] / Ws;
  const float mmx = tot[3] / Ws;
  const float mmy = tot[4] / Ws;
  const float H00 = tot[5] - W * mqx * mmx;
  const float H01 = tot[6] - W * mqx * mmy;
  const float H10 = tot[7] - W * mqy * mmx;
  const float H11 = tot[8] - W * mqy * mmy;
  const float a = H00 + H11;
  const float bb = H01 - H10;
  const float rn = 1.f / sqrtf(fmaxf(a * a + bb * bb, 1e-24f));
  const float c_ = a * rn;
  const float s_ = bb * rn;
  const float t_x = mmx - (c_ * mqx - s_ * mqy);
  const float t_y = mmy - (s_ * mqx + c_ * mqy);
  const float ntx = c_ * tx - s_ * ty + t_x;
  const float nty = s_ * tx + c_ * ty + t_y;
  float ncth = c_ * cth - s_ * sth;
  float nsth = s_ * cth + c_ * sth;
  const float rnorm = 1.f / sqrtf(fmaxf(ncth * ncth + nsth * nsth, 1e-24f));
  ncth = ncth * rnorm;
  nsth = nsth * rnorm;
  const float frob = sqrtf(fmaxf(4.f - 4.f * c_, 0.f));
  const bool has_corr = W > 0.f;
  const float d = has_corr ? fmaxf(frob, sqrtf(t_x * t_x + t_y * t_y)) : -1.f;
  if (has_corr) {
    carry[0] = ntx;
    carry[1] = nty;
    carry[2] = ncth;
    carry[3] = nsth;
  }
  carry[5] = W;
  carry[6] = tot[9] / Ws;
  carry[7] = d;
  carry[4] = (d < min_delta) ? 1.f : 0.f;
}

}  // namespace slam_icp
