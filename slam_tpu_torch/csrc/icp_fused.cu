// K1: the whole class-constrained 2D ICP fit loop, one CUDA block per robot.
//
// Replaces: slam_tpu/ops/icp_pallas.py `_icp_kernel_planes` -> `_icp_core`
// (the resident Pallas kernel behind `_icp_batched_planes` and
// `fused_register`), and through the packed adapter `_icp_kernel`.
//
// What bounds it on the card: f32 instruction throughput, not device memory.
// Per fit iteration a robot evaluates one squared distance for every
// (scene, model) pair of one class; the operands are 3 (S + C) floats
// (10.8 KB at S = 384, C = 512), read from device memory once per call.
// The distance is five separately rounded operations (the tie test needs
// them bit-equal everywhere, so no multiply-add is fused), where the bound
// counts five operations at the fused rate: the exact rounding alone costs
// 2x against the bound. The TPU kernel kept an (S, C) tile in VMEM; here no
// tile exists at all.
//
// What the design does about it:
// - staging groups by class: the model's class-1 points, then its class-0
//   points, as packed (x, y) pairs in shared memory, invalid ones dropped,
//   each group in the model's order (warp ballots and prefix counts, no
//   atomics); the scene's valid points likewise. A scene point then walks
//   its own class's segment only: no class test, no pair of two classes, one
//   8-byte broadcast read a model point;
// - one pass instead of two: the running merge of slam_icp::nearest_merge
//   (a strictly smaller distance replaces minimum, tie sums and tie count,
//   an equal one adds), the same code K3 compiles, so the tie sets and the
//   order of the tie sums are those of the two-pass form;
// - R scene points a thread share each model read; a warp takes tasks of
//   32 R points of one class, and a block has one warp a task, up to 32.
//   Measured on the H100, one point a thread (R = 1) is fastest wherever the
//   tasks fit the block (S <= 1024: 13 warps a robot at S = 384, 9 at
//   S = 256; 2 or 4 points a thread were slower there): a robot's
//   iteration is a chain of dependent steps, a fleet's call ends with its
//   slowest robots (those that never converge run all max_iterations), and
//   more warps a robot shorten that chain. Larger scenes take R = 2, where
//   each warp would otherwise loop over several tasks;
// - the ten Kabsch moments reduce across the block in a fixed order; one
//   thread updates the pose and the converged flag, which the whole block
//   reads, so the loop exit is uniform per block.
//
// Semantics follow `_icp_core`: the ok gate, class participation only where
// the model holds > 3 points of the class, `d2 <= rowmin` ties averaged,
// the 1e-12 / 1e-24 floors, the no-correspondence freeze with delta = -1,
// the initial carry (ncorr 0, mres 0, delta inf) and the final ok-select of
// the pose. Pairs of different class are skipped instead of penalised
// (their BIG + d2 is exactly BIG in f32 and can never be a participating
// point's minimum, because participation requires > 3 model points of the
// class).

#include <cuda_runtime.h>
#include <math.h>

#include "icp_common.cuh"

namespace {

using namespace slam_icp;

template <int R>
__global__ void __launch_bounds__(32 * kMaxWarps)
icp_fused_planes_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                        const float* __restrict__ sc, const float* __restrict__ mx,
                        const float* __restrict__ my, const float* __restrict__ mc,
                        const float* __restrict__ init4, float* __restrict__ out,
                        unsigned long long* __restrict__ iters, int S, int C, int max_iter,
                        float inlier_dist, float min_delta, int min_scene) {
  extern __shared__ float2 points[];   // C model points, then S scene points
  float2* model = points;
  float2* rows = points + C;
  __shared__ int wcnt[2 * kMaxWarps * kCounts];
  __shared__ float red[kMaxWarps * kMoments];
  __shared__ float tot[kMoments];
  // carry: tx, ty, cos, sin, converged, ncorr, mres, delta
  __shared__ float carry[8];

  const int b = blockIdx.x;
  const size_t so = (size_t)b * S;
  const size_t mo = (size_t)b * C;
  int* scnt = wcnt + kMaxWarps * kCounts;

  class_count(mc + mo, C, wcnt);
  class_count(sc + so, S, scnt);
  __syncthreads();
  int m_tot[kCounts], s_tot[kCounts], m_b1, m_b0, s_b1, s_b0;
  class_totals(wcnt, m_tot, m_b1, m_b0);
  class_totals(scnt, s_tot, s_b1, s_b0);
  class_scatter(mx + mo, my + mo, mc + mo, C, model, model + m_tot[0], m_b1, m_b0);
  class_scatter(sx + so, sy + so, sc + so, S, rows, rows + s_tot[0], s_b1, s_b0);

  const bool ok = (s_tot[2] >= min_scene) && (m_tot[0] + m_tot[1] >= 5);
  const float i_tx = init4[4 * b + 0];
  const float i_ty = init4[4 * b + 1];
  const float i_c = init4[4 * b + 2];
  const float i_s = init4[4 * b + 3];
  if (threadIdx.x == 0) {
    carry[0] = i_tx;
    carry[1] = i_ty;
    carry[2] = i_c;
    carry[3] = i_s;
    carry[4] = ok ? 0.f : 1.f;
    carry[5] = 0.f;
    carry[6] = 0.f;
    carry[7] = INFINITY;
  }
  __syncthreads();  // the grouped points and the carry are ready

  Grouped g;
  g.rows = rows;
  g.model = model;
  g.rows_0 = s_tot[0];
  g.model_0 = m_tot[0];
  g.m1 = m_tot[0];
  g.m0 = m_tot[1];
  g.n1 = m_tot[0] > 3 ? s_tot[0] : 0;   // a class is on with > 3 model points
  g.n0 = m_tot[1] > 3 ? s_tot[1] : 0;
  const int n_iter = resident_fit<R>(g, carry, red, tot, max_iter, inlier_dist, min_delta);

  if (threadIdx.x == 0) {
    if (iters != nullptr && n_iter > 0) atomicAdd(iters, (unsigned long long)n_iter);
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

template <int R>
int launch(const float* sx, const float* sy, const float* sc, const float* mx,
           const float* my, const float* mc, const float* init4, float* out,
           unsigned long long* iters, int B, int S, int C, int max_iter, float inlier_dist,
           float min_delta, int min_scene, cudaStream_t stream) {
  // one warp a task of 32 R scene points; the two classes round up apart
  const int warps = min(kMaxWarps, (S + 32 * R - 1) / (32 * R) + 1);
  const size_t smem = (size_t)(S + C) * sizeof(float2);
  if (smem + 4096 > 48 * 1024) {  // with the static part, above the default limit
    const cudaError_t e = cudaFuncSetAttribute(
        icp_fused_planes_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  icp_fused_planes_kernel<R><<<B, 32 * warps, smem, stream>>>(
      sx, sy, sc, mx, my, mc, init4, out, iters, S, C, max_iter, inlier_dist, min_delta,
      min_scene);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Planes are contiguous (B, S) and
// (B, C) f32; init4 is (B, 4) [x, y, cos, sin]; out is (B, 8)
// [tx, ty, cos, sin, ok, ncorr, mres, delta]. iters, when not null, is one
// counter to which each robot adds the fit iterations it ran. Scene points a
// thread by the scene's size: 1 up to S = 1024, else 2. Returns
// cudaGetLastError().
extern "C" int slam_icp_fused_planes(const float* sx, const float* sy, const float* sc,
                                     const float* mx, const float* my, const float* mc,
                                     const float* init4, float* out,
                                     unsigned long long* iters, int B, int S, int C,
                                     int max_iter, float inlier_dist, float min_delta,
                                     int min_scene, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 32 * kMaxWarps)
    return launch<1>(sx, sy, sc, mx, my, mc, init4, out, iters, B, S, C, max_iter,
                     inlier_dist, min_delta, min_scene, st);
  return launch<2>(sx, sy, sc, mx, my, mc, init4, out, iters, B, S, C, max_iter,
                   inlier_dist, min_delta, min_scene, st);
}
