// K3: the class-constrained 2D ICP fit loop for problems of any size, the
// model streamed through shared memory in tiles.
//
// Replaces: slam_tpu/ops/icp_pallas.py `_icp_kernel_tiled` (behind
// `_icp_batched_planes_tiled`, `make_icp_fused_planes_tiled` and
// `fused_register` above RESIDENT_TILE_LIMIT), the reference-scale route:
// B = 16 robots, S = 4096 scene points, C = 40,960 model points.
//
// What bounds it on the card: arithmetic. One fit iteration evaluates
// B x S x C = 2.7e9 (scene, model) pairs at the reference's working point,
// while the operands are 3 x (S + C) floats per robot (0.5 MB), read once
// per iteration and served from L2 after the first.
//
// What the design does about it:
// - K1 keeps a robot's whole model in one block's shared memory: at
//   C = 40,960 that is 480 KB, which does not fit, and one block per robot
//   would leave 116 of 132 SMs idle at B = 16. Here a grid of (S-chunk x
//   robot) blocks of 128 threads (512 blocks at the working point) gives
//   each thread one scene point, and the block walks the model in tiles of
//   2048 points staged in shared memory as float4 (x, y, class, -), one
//   16-byte broadcast read per pair;
// - each thread carries its point's running (row minimum, tie sums, tie
//   count) across tiles with the TPU kernel's merge: a strictly smaller
//   distance replaces them, an equal one adds. The tie set is therefore
//   exactly K1's (d2 comes from the same rounded `sqdist`, -fmad=false),
//   and the tie sums add in model order, as K1's do;
// - pairs of different class are skipped, as in K1; the TPU kernel
//   penalises them by BIG (sc - mc)^2 instead, which gives the same result
//   for every participating point (classes are in {-1, 0, 1, 2} and a
//   participating point's class has > 3 model points);
// - no float atomics: each block reduces its ten Kabsch moments in a fixed
//   order into its own slot of a (B, chunks, 10) buffer, and a per-robot
//   finalize kernel sums the slots in chunk order and updates the pose, so
//   the same inputs give the same pose on every run;
// - a robot's state (pose, converged flag) lives in device memory; the
//   host queues max_iterations (match, finalize) pairs with no sync in
//   between, and the blocks of a converged robot exit at once.

#include <cuda_runtime.h>
#include <math.h>

#include "icp_common.cuh"

namespace {

constexpr int kRows = 128;     // scene points per match block, one per thread
constexpr int kTile = 2048;    // model points per shared-memory tile
constexpr int kMoments = 10;
constexpr int kSetupThreads = 256;
constexpr int kFinalizeThreads = 64;
// per-robot state: 0..7 the carry [tx, ty, cos, sin, converged, ncorr,
// mres, delta], 8 ok, 9 GA class on, 10 NGA class on
constexpr int kState = 16;

__global__ void __launch_bounds__(kSetupThreads)
k3_setup(const float* __restrict__ sc, const float* __restrict__ mc,
         const float* __restrict__ init4, float* __restrict__ state,
         float* __restrict__ out, int S, int C, int min_scene) {
  __shared__ float red[kSetupThreads / 32 * 3];
  __shared__ float tot[3];
  const int b = blockIdx.x;
  float cnt[3] = {0.f, 0.f, 0.f};  // model GA, model NGA, valid scene
  for (int c = threadIdx.x; c < C; c += kSetupThreads) {
    const float m = mc[(size_t)b * C + c];
    cnt[0] += (m == 1.f) ? 1.f : 0.f;
    cnt[1] += (m == 0.f) ? 1.f : 0.f;
  }
  for (int r = threadIdx.x; r < S; r += kSetupThreads)
    cnt[2] += (sc[(size_t)b * S + r] >= 0.f) ? 1.f : 0.f;
  slam_icp::block_sum<kSetupThreads, 3>(cnt, red, tot);
  if (threadIdx.x == 0) {
    const bool ok = (tot[2] >= (float)min_scene) && (tot[0] + tot[1] >= 5.f);
    float* st = state + (size_t)b * kState;
    float* o = out + 8 * (size_t)b;
    for (int k = 0; k < 4; ++k) st[k] = o[k] = init4[4 * b + k];
    st[4] = ok ? 0.f : 1.f;
    st[5] = o[5] = 0.f;
    st[6] = o[6] = 0.f;
    st[7] = o[7] = INFINITY;
    st[8] = o[4] = ok ? 1.f : 0.f;
    st[9] = tot[0] > 3.f ? 1.f : 0.f;
    st[10] = tot[1] > 3.f ? 1.f : 0.f;
  }
}

__global__ void __launch_bounds__(kRows)
k3_match(const float* __restrict__ sx, const float* __restrict__ sy,
         const float* __restrict__ sc, const float* __restrict__ mx,
         const float* __restrict__ my, const float* __restrict__ mc,
         const float* __restrict__ state, float* __restrict__ partial,
         int S, int C, float inlier_dist) {
  __shared__ float4 tile[kTile];
  __shared__ float red[kRows / 32 * kMoments];
  __shared__ float tot[kMoments];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* st = state + (size_t)b * kState;
  if (st[4] != 0.f) return;  // converged (or below the ok gates): the whole block

  const int r = blockIdx.x * kRows + tid;
  bool part = false;
  float cls = -1.f, qx = 0.f, qy = 0.f;
  if (r < S) {
    cls = sc[(size_t)b * S + r];
    part = cls >= 0.f && (cls == 1.f ? st[9] != 0.f : st[10] != 0.f);
    slam_icp::transform(sx[(size_t)b * S + r], sy[(size_t)b * S + r], st[0], st[1], st[2],
                        st[3], qx, qy);
  }
  float rowmin = INFINITY, tsx = 0.f, tsy = 0.f, nt = 0.f;
  const size_t mo = (size_t)b * C;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int n = min(kTile, C - c0);
    __syncthreads();  // the previous tile is consumed
    for (int k = tid; k < n; k += kRows)
      tile[k] = make_float4(mx[mo + c0 + k], my[mo + c0 + k], mc[mo + c0 + k], 0.f);
    __syncthreads();
    if (part) {
      for (int k = 0; k < n; ++k) {
        const float4 m = tile[k];
        if (m.z != cls) continue;
        const float d = slam_icp::sqdist(qx, qy, m.x, m.y);
        if (d < rowmin) {
          rowmin = d;
          tsx = m.x;
          tsy = m.y;
          nt = 1.f;
        } else if (d == rowmin) {
          tsx += m.x;
          tsy += m.y;
          nt += 1.f;
        }
      }
    }
  }

  float acc[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.f;
  if (part && rowmin < inlier_dist) {
    const float inv_nt = 1.f / fmaxf(nt, 1.f);
    const float ux = tsx * inv_nt;
    const float uy = tsy * inv_nt;
    acc[0] = 1.f;
    acc[1] = qx;
    acc[2] = qy;
    acc[3] = ux;
    acc[4] = uy;
    acc[5] = qx * ux;
    acc[6] = qx * uy;
    acc[7] = qy * ux;
    acc[8] = qy * uy;
    acc[9] = rowmin;
  }
  slam_icp::block_sum<kRows, kMoments>(acc, red, tot);
  if (tid == 0) {
    float* p = partial + ((size_t)b * gridDim.x + blockIdx.x) * kMoments;
#pragma unroll
    for (int k = 0; k < kMoments; ++k) p[k] = tot[k];
  }
}

__global__ void __launch_bounds__(kFinalizeThreads)
k3_finalize(float* __restrict__ state, const float* __restrict__ partial,
            float* __restrict__ out, int B, int n_chunks, float min_delta) {
  const int b = blockIdx.x * kFinalizeThreads + threadIdx.x;
  if (b >= B) return;
  float* st = state + (size_t)b * kState;
  if (st[4] != 0.f) return;
  float tot[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) tot[k] = 0.f;
  const float* p = partial + (size_t)b * n_chunks * kMoments;
  for (int ch = 0; ch < n_chunks; ++ch) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) tot[k] += p[ch * kMoments + k];
  }
  float carry[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) carry[k] = st[k];
  slam_icp::pose_update(tot, carry, min_delta);
  float* o = out + 8 * (size_t)b;
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = carry[k];
  for (int k = 0; k < 4; ++k) o[k] = carry[k];
  o[5] = carry[5];
  o[6] = carry[6];
  o[7] = carry[7];
}

}  // namespace

// Plain C entry point (bound with ctypes). Planes are contiguous (B, S) and
// (B, C) f32 with the classes of K1; init4 is (B, 4) [x, y, cos, sin]; out
// is (B, 8) [tx, ty, cos, sin, ok, ncorr, mres, delta]. state (B, 16) and
// partial (B, ceil(S / 128), 10) are f32 scratch. Queues the whole fit loop
// on `stream` and returns the first cudaGetLastError() that is not 0.
extern "C" int slam_icp_tiled_planes(const float* sx, const float* sy, const float* sc,
                                     const float* mx, const float* my, const float* mc,
                                     const float* init4, float* out, float* state,
                                     float* partial, int B, int S, int C, int max_iter,
                                     float inlier_dist, float min_delta, int min_scene,
                                     void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  k3_setup<<<B, kSetupThreads, 0, st>>>(sc, mc, init4, state, out, S, C, min_scene);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (S + kRows - 1) / kRows;
  const dim3 grid(n_chunks, B);
  const int fin_blocks = (B + kFinalizeThreads - 1) / kFinalizeThreads;
  for (int it = 0; it < max_iter; ++it) {
    if (n_chunks > 0)
      k3_match<<<grid, kRows, 0, st>>>(sx, sy, sc, mx, my, mc, state, partial, S, C,
                                       inlier_dist);
    k3_finalize<<<fin_blocks, kFinalizeThreads, 0, st>>>(state, partial, out, B, n_chunks,
                                                         min_delta);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
