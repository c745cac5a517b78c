// Device code shared by the fused-ICP kernels K1 (icp_fused.cu) and K3
// (icp_tiled.cu): the rounded distance, the stable grouping of points by
// class, the nearest-point merge (one inner loop, compiled into K1, into
// K3's resident branch and into K3's streaming branch, so that all three
// round alike), the resident fit loop and the pose update.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace slam_icp {

constexpr int kMoments = 10;
constexpr int kMaxWarps = 32;   // warps of the largest block
constexpr int kCounts = 3;      // class 1, class 0, class >= 0

// Squared distance with every product and sum rounded on its own: the tie
// test compares two such values for exact equality, so every place that
// computes d2 rounds it the same way (the files are also built with
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

// Sum v[0..N) over the block in a fixed order (warp shuffles, then the
// warps' sums by shuffles in the first warp); every thread gets the totals
// in `total`. `red` holds (blockDim.x / 32) * N floats; blockDim.x is a
// multiple of 32, at most 32 warps.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, float* total) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = lane < n_warps ? red[lane * N + k] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) total[k] = s;
    }
  }
  __syncthreads();
}

// ---- stable grouping by class -------------------------------------------
// A block splits cls[0..n) into one contiguous slice a warp. class_count
// leaves each warp's counts (class 1, class 0, class >= 0) in wcnt
// [warp][kCounts]; after a __syncthreads, class_totals gives every thread
// the block's totals and its own warp's offsets; class_scatter then writes
// (x, y) of the class-1 points to dst1 and of the class-0 points to dst0,
// each in the order of the input. No atomics: the order is the input's on
// every run.

constexpr int kBatch = 4;  // loads a thread keeps in flight while grouping

__device__ __forceinline__ int class_slice(int n) {
  const int n_warps = blockDim.x >> 5;
  return ((n + n_warps - 1) / n_warps + 31) & ~31;
}

__device__ __forceinline__ void class_count(const float* __restrict__ cls, int n, int* wcnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = class_slice(n);
  const int beg = warp * per;
  const int end = min(n, beg + per);
  int c1 = 0, c0 = 0, cv = 0;
  for (int i = beg; i < end; i += 32 * kBatch) {
    float c[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = i + 32 * u + lane;
      c[u] = k < end ? cls[k] : -1.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      c1 += __popc(__ballot_sync(0xffffffffu, c[u] == 1.f));
      c0 += __popc(__ballot_sync(0xffffffffu, c[u] == 0.f));
      cv += __popc(__ballot_sync(0xffffffffu, c[u] >= 0.f));
    }
  }
  if (lane == 0) {
    wcnt[warp * kCounts + 0] = c1;
    wcnt[warp * kCounts + 1] = c0;
    wcnt[warp * kCounts + 2] = cv;
  }
}

__device__ __forceinline__ void class_totals(const int* wcnt, int (&total)[kCounts],
                                             int& base1, int& base0) {
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  total[0] = total[1] = total[2] = 0;
  base1 = base0 = 0;
  for (int w = 0; w < n_warps; ++w) {
    if (w == warp) {
      base1 = total[0];
      base0 = total[1];
    }
#pragma unroll
    for (int k = 0; k < kCounts; ++k) total[k] += wcnt[w * kCounts + k];
  }
}

__device__ __forceinline__ void class_scatter(const float* __restrict__ x,
                                              const float* __restrict__ y,
                                              const float* __restrict__ cls, int n,
                                              float2* __restrict__ dst1,
                                              float2* __restrict__ dst0, int base1,
                                              int base0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = class_slice(n);
  const int beg = warp * per;
  const int end = min(n, beg + per);
  const unsigned below = (1u << lane) - 1u;
  for (int i = beg; i < end; i += 32 * kBatch) {
    float c[kBatch];
    float2 p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = i + 32 * u + lane;
      const bool in = k < end;
      c[u] = in ? cls[k] : -1.f;
      p[u] = in ? make_float2(x[k], y[k]) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const unsigned b1 = __ballot_sync(0xffffffffu, c[u] == 1.f);
      const unsigned b0 = __ballot_sync(0xffffffffu, c[u] == 0.f);
      if (c[u] == 1.f) dst1[base1 + __popc(b1 & below)] = p[u];
      if (c[u] == 0.f) dst0[base0 + __popc(b0 & below)] = p[u];
      base1 += __popc(b1);
      base0 += __popc(b0);
    }
  }
}

// ---- the nearest-point merge ---------------------------------------------
// One thread holds RE scene points (qx, qy) of one class with their running
// (row minimum, tie sums, tie count) and walks n model points of that class:
// a strictly smaller distance replaces the running values, an equal one
// adds. One read of a model point feeds RE pairs, and the merge branch is
// entered only when one of the RE distances reaches its row minimum.
// Starting the minimum at inlier_dist (with a tie count of 0) instead of
// infinity leaves every result the fit uses unchanged: a point contributes
// only where its minimum is below inlier_dist, and then every model point at
// that minimum is below the start and is merged as before.
template <int RE, int R>
__device__ __forceinline__ void nearest_merge(const float2* __restrict__ m, int n,
                                              const float (&qx)[R], const float (&qy)[R],
                                              float (&rmin)[R], float (&tsx)[R],
                                              float (&tsy)[R], float (&nt)[R]) {
  static_assert(RE <= R, "RE rows of the R a thread can hold");
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float2 p = m[k];
    float d[RE];
    bool hit = false;
#pragma unroll
    for (int j = 0; j < RE; ++j) {
      d[j] = sqdist(qx[j], qy[j], p.x, p.y);
      hit |= d[j] <= rmin[j];
    }
    if (hit) {
#pragma unroll
      for (int j = 0; j < RE; ++j) {
        if (d[j] < rmin[j]) {
          rmin[j] = d[j];
          tsx[j] = p.x;
          tsy[j] = p.y;
          nt[j] = 1.f;
        } else if (d[j] == rmin[j]) {
          tsx[j] += p.x;
          tsy[j] += p.y;
          nt[j] += 1.f;
        }
      }
    }
  }
}

// Calls f(integral_constant<int, re>) for the run-time re in 1..R.
template <int R, typename F>
__device__ __forceinline__ void dispatch_rows(int re, F&& f) {
  if constexpr (R > 1) {
    if (re < R) {
      dispatch_rows<R - 1>(re, f);
      return;
    }
  }
  f(std::integral_constant<int, R>{});
}

// Adds one scene point's share of the ten Kabsch moments.
__device__ __forceinline__ void add_moments(float (&acc)[kMoments], float qx, float qy,
                                            float rmin, float tsx, float tsy, float nt) {
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
  acc[9] += rmin;
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

// ---- the resident fit loop -------------------------------------------------
// A robot's class-grouped points, all in one block's shared memory.
struct Grouped {
  const float2* rows;   // class-1 scene points, then class-0 ones from rows_0
  const float2* model;  // class-1 model points, then class-0 ones from model_0
  int rows_0, model_0;  // where the class-0 segments start
  int n1, n0;           // participating scene points of class 1, class 0
  int m1, m0;           // model points of class 1, class 0
};

// The whole fit loop of one robot in one block. A warp takes tasks of up
// to 32 R scene points of one class (a class's points spread evenly over
// its tasks), R or fewer a lane, and walks that class's model segment once
// per iteration. carry (shared, 8 floats) holds the pose and the converged
// flag and is ready on entry; red holds (blockDim.x / 32) * kMoments
// floats, tot kMoments. Ends after a __syncthreads with the result in carry;
// returns the fit iterations it ran (the same in every thread).
template <int R>
__device__ __forceinline__ int resident_fit(const Grouped& g, float* carry, float* red,
                                            float* tot, int max_iter, float inlier_dist,
                                            float min_delta) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int t1 = (g.n1 + 32 * R - 1) / (32 * R);
  const int t0 = (g.n0 + 32 * R - 1) / (32 * R);
  int it = 0;
  for (; it < max_iter && carry[4] == 0.f; ++it) {
    const float tx = carry[0], ty = carry[1], cth = carry[2], sth = carry[3];
    float acc[kMoments];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) acc[k] = 0.f;
    for (int task = warp; task < t1 + t0; task += n_warps) {
      const bool one = task < t1;
      const int t = one ? task : task - t1;
      const int n_rows = one ? g.n1 : g.n0;
      const int n_tasks = one ? t1 : t0;
      const int beg = (int)((long long)t * n_rows / n_tasks);
      const int cnt = (int)((long long)(t + 1) * n_rows / n_tasks) - beg;
      const float2* rows = g.rows + (one ? 0 : g.rows_0) + beg;
      const float2* seg = g.model + (one ? 0 : g.model_0);
      const int seg_n = one ? g.m1 : g.m0;
      dispatch_rows<R>((cnt + 31) / 32, [&](auto re) {
        constexpr int RE = decltype(re)::value;
        float qx[RE], qy[RE], rmin[RE], tsx[RE], tsy[RE], nt[RE];
#pragma unroll
        for (int j = 0; j < RE; ++j) {
          const bool have = j * 32 + lane < cnt;
          const float2 p = have ? rows[j * 32 + lane] : make_float2(0.f, 0.f);
          transform(p.x, p.y, tx, ty, cth, sth, qx[j], qy[j]);
          rmin[j] = have ? inlier_dist : -1.f;  // -1: no distance reaches it
          tsx[j] = tsy[j] = nt[j] = 0.f;
        }
        nearest_merge<RE>(seg, seg_n, qx, qy, rmin, tsx, tsy, nt);
#pragma unroll
        for (int j = 0; j < RE; ++j) {
          if (j * 32 + lane < cnt && rmin[j] < inlier_dist)
            add_moments(acc, qx[j], qy[j], rmin[j], tsx[j], tsy[j], nt[j]);
        }
      });
    }
    block_sum<kMoments>(acc, red, tot);
    if (threadIdx.x == 0) pose_update(tot, carry, min_delta);
    __syncthreads();
  }
  return it;
}

}  // namespace slam_icp
