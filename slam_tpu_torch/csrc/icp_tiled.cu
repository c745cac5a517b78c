// K3: the class-constrained 2D ICP fit loop for problems of any size.
//
// Replaces: slam_tpu/ops/icp_pallas.py `_icp_kernel_tiled` (behind
// `_icp_batched_planes_tiled`, `make_icp_fused_planes_tiled` and
// `fused_register` above RESIDENT_TILE_LIMIT), the reference-scale route:
// B = 16 robots, S = 4096 scene slots, C = 40,960 model slots.
//
// What bounds it on the card: f32 instruction throughput on the pairs of
// one class that the data really holds, never the slots. At the reference
// scale a robot's scene fills ~70 of its 4096 slots and its target ~140 of
// 40,960, so a fit iteration is ~5,000 pairs a robot and the call is bound
// by its launches and by reading the planes once (0.5 MB a robot); a full
// problem is 16 x 4096 x 40,960 / 2 pairs an iteration. As in K1 the
// separately rounded distance costs 2x against a bound that counts fused
// operations.
//
// What the design does about it:
// - one set-up kernel a call, one block a robot, groups the robot's points
//   by class, stably and without atomics (slam_icp::class_*): the valid
//   scene points and the model's class-1 and class-0 points as packed (x, y)
//   pairs, invalid slots dropped, each class in the input's order, so the
//   tie sums still add in model order. The ok gates and "class on" (> 3
//   model points) come from the same counts;
// - a robot whose grouped points fit (kResRows scene points, kResModel
//   model points, kResPairs pairs) never leaves that block: the points go
//   to shared memory and the whole fit loop runs there, K1's way
//   (slam_icp::resident_fit). The reference scale's real data takes this
//   branch, decided on the card; the host never learns the sizes;
// - the other robots stream. The set-up kernel writes their grouped points
//   to scratch and cuts the work of one class into items: a chunk of up to
//   kChunk scene points x a split of up to kSplit model points. One match
//   block takes one item: it copies the split to shared memory with
//   cp.async while each thread loads and transforms its kR scene points,
//   walks it with the running merge K1 compiles (slam_icp::nearest_merge)
//   and writes every point's (minimum, tie sums, tie count) for this split.
//   So 16 full robots spread over all 132 SMs (~170 items each: the last
//   robots to converge still fill the card), and a robot with few scene
//   points still splits its model over many blocks. A split is one buffer:
//   longer splits streamed through a two-buffer cp.async ring were measured
//   slower (fewer items, and twice the shared memory a block), so staging
//   overlaps with the other blocks of the SM, not inside a block. The grid
//   is the worst case for the shapes; a block beyond the robot's items, or
//   of a robot that converged or stayed resident, returns before it stages
//   anything;
// - no float atomics and no second kernel: the block that finishes a
//   robot's last item (one integer counter a robot) merges every point's
//   splits in split order with the same rule, sums the ten Kabsch moments
//   in a fixed order and updates the pose, so the same inputs give the same
//   pose on every run, whichever block comes last;
// - a call queues 1 + max_iterations launches (21 at the default 20; the
//   first design queued 41), with no host sync; when every robot stayed
//   resident the match launches return at once.
//
// Pairs of different class are skipped, as in K1; the TPU kernel penalises
// them by BIG (sc - mc)^2 instead, which gives the same result for every
// participating point (classes are in {-1, 0, 1, 2} and a participating
// point's class has > 3 model points).

#include <cuda_runtime.h>
#include <math.h>

#include "icp_common.cuh"

namespace {

using namespace slam_icp;

constexpr int kSetupThreads = 1024;
constexpr int kMatchThreads = 128;
constexpr int kR = 2;                         // scene points a match thread
constexpr int kChunk = kMatchThreads * kR;    // scene points a match block
constexpr int kSplit = 2048;                  // model points a match block
constexpr int kResRows = 1024;                // resident branch: scene points,
constexpr int kResModel = 4096;               //   model points,
constexpr int kResPairs = 1 << 18;            //   scene x model points
// per-robot state (floats): 0..7 the carry [tx, ty, cos, sin, converged,
// ncorr, mres, delta]
constexpr int kState = 8;
// per-robot plan (ints)
enum Plan { kN1, kN0, kRows0, kM1, kM0, kRc1, kRc0, kNs1, kNs0, kItems, kDone, kPlan = 12 };

__device__ __forceinline__ void write_out(float* o, const float* carry, float ok) {
  o[0] = carry[0];
  o[1] = carry[1];
  o[2] = carry[2];
  o[3] = carry[3];
  o[4] = ok;
  o[5] = carry[5];
  o[6] = carry[6];
  o[7] = carry[7];
}

__global__ void __launch_bounds__(kSetupThreads)
k3_setup(const float* __restrict__ sx, const float* __restrict__ sy,
         const float* __restrict__ sc, const float* __restrict__ mx,
         const float* __restrict__ my, const float* __restrict__ mc,
         const float* __restrict__ init4, float* __restrict__ out,
         float* __restrict__ state, int* __restrict__ plan, float2* __restrict__ grouped,
         unsigned long long* __restrict__ iters, int S, int C, int max_iter,
         float inlier_dist, float min_delta, int min_scene) {
  __shared__ float2 s_model[kResModel];
  __shared__ float2 s_rows[kResRows];
  __shared__ int wcnt[2 * kMaxWarps * kCounts];
  __shared__ float red[kMaxWarps * kMoments];
  __shared__ float tot[kMoments];
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

  const bool ok = (s_tot[2] >= min_scene) && (m_tot[0] + m_tot[1] >= 5);
  Grouped g;
  g.rows_0 = s_tot[0];
  g.model_0 = m_tot[0];
  g.m1 = m_tot[0];
  g.m0 = m_tot[1];
  g.n1 = m_tot[0] > 3 ? s_tot[0] : 0;   // a class is on with > 3 model points
  g.n0 = m_tot[1] > 3 ? s_tot[1] : 0;
  const bool resident = s_tot[0] + s_tot[1] <= kResRows && g.m1 + g.m0 <= kResModel &&
                        (long long)(g.n1 + g.n0) * max(g.m1, g.m0) <= kResPairs;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) carry[k] = init4[4 * b + k];
    carry[4] = ok ? 0.f : 1.f;
    carry[5] = 0.f;
    carry[6] = 0.f;
    carry[7] = INFINITY;
  }
  float* st = state + (size_t)b * kState;
  float* o = out + 8 * (size_t)b;
  int* pl = plan + (size_t)b * kPlan;

  if (!ok || resident) {  // the same for the whole block
    if (ok) {
      class_scatter(mx + mo, my + mo, mc + mo, C, s_model, s_model + g.model_0, m_b1, m_b0);
      class_scatter(sx + so, sy + so, sc + so, S, s_rows, s_rows + g.rows_0, s_b1, s_b0);
    }
    __syncthreads();  // the grouped points and the carry are ready
    g.rows = s_rows;
    g.model = s_model;
    const int n_iter = resident_fit<1>(g, carry, red, tot, max_iter, inlier_dist, min_delta);
    if (threadIdx.x == 0) {
      if (iters != nullptr && n_iter > 0) atomicAdd(iters, (unsigned long long)n_iter);
      write_out(o, carry, ok ? 1.f : 0.f);
      st[4] = 1.f;  // nothing left for the match launches
      pl[kItems] = 0;
    }
    return;
  }

  float2* g_model = grouped + (size_t)b * (S + C);
  float2* g_rows = g_model + C;
  class_scatter(mx + mo, my + mo, mc + mo, C, g_model, g_model + g.model_0, m_b1, m_b0);
  class_scatter(sx + so, sy + so, sc + so, S, g_rows, g_rows + g.rows_0, s_b1, s_b0);
  __syncthreads();  // the carry is ready
  if (threadIdx.x == 0) {
    const int rc1 = (g.n1 + kChunk - 1) / kChunk, rc0 = (g.n0 + kChunk - 1) / kChunk;
    const int ns1 = (g.m1 + kSplit - 1) / kSplit;
    const int ns0 = (g.m0 + kSplit - 1) / kSplit;
    const int items = rc1 * ns1 + rc0 * ns0;
    if (items == 0) {  // no participating scene point: one update without moments
      float zero[kMoments];
      for (int k = 0; k < kMoments; ++k) zero[k] = 0.f;
      pose_update(zero, carry, min_delta);
      if (iters != nullptr) atomicAdd(iters, 1ull);
    }
    pl[kN1] = g.n1;
    pl[kN0] = g.n0;
    pl[kRows0] = g.rows_0;
    pl[kM1] = g.m1;
    pl[kM0] = g.m0;
    pl[kRc1] = rc1;
    pl[kRc0] = rc0;
    pl[kNs1] = ns1;
    pl[kNs0] = ns0;
    pl[kItems] = items;
    pl[kDone] = 0;
    for (int k = 0; k < kState; ++k) st[k] = carry[k];
    write_out(o, carry, 1.f);
  }
}

// 8-byte asynchronous copy from device memory to shared memory.
__device__ __forceinline__ void copy_async8(float2* dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Merges one scene point's splits, in split order, with the merge's rule.
__device__ __forceinline__ void merge_splits(const float4* __restrict__ part, int n_splits,
                                             size_t stride, float inlier_dist, float& rmin,
                                             float& tsx, float& tsy, float& nt) {
  rmin = inlier_dist;
  tsx = tsy = nt = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float4 p = __ldcg(part + s * stride);
    if (p.x < rmin) {
      rmin = p.x;
      tsx = p.y;
      tsy = p.z;
      nt = p.w;
    } else if (p.x == rmin) {
      tsx += p.y;
      tsy += p.z;
      nt += p.w;
    }
  }
}

__global__ void __launch_bounds__(kMatchThreads)
k3_match(float* __restrict__ out, float* __restrict__ state, int* __restrict__ plan,
         const float2* __restrict__ grouped, float4* __restrict__ partial,
         unsigned long long* __restrict__ iters, int S, int C, int max_splits,
         float inlier_dist, float min_delta) {
  __shared__ float2 tile[kSplit];
  __shared__ float red[kMatchThreads / 32 * kMoments];
  __shared__ float tot[kMoments];
  __shared__ int last;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  float* st = state + (size_t)b * kState;
  int* pl = plan + (size_t)b * kPlan;
  if (st[4] != 0.f) return;  // converged, resident or below the ok gates
  int item = blockIdx.x;
  if (item >= pl[kItems]) return;

  // the item: a chunk of one class's scene points x a split of its model
  const bool one = item < pl[kRc1] * pl[kNs1];
  if (!one) item -= pl[kRc1] * pl[kNs1];
  const int n_splits = one ? pl[kNs1] : pl[kNs0];
  const int n_chunks = one ? pl[kRc1] : pl[kRc0];
  const int n_rows = one ? pl[kN1] : pl[kN0];
  const int n_model = one ? pl[kM1] : pl[kM0];
  const int chunk = item / n_splits;
  const int split = item - chunk * n_splits;
  const int row_off = one ? 0 : pl[kRows0];
  const int r_beg = (int)((long long)chunk * n_rows / n_chunks);
  const int r_cnt = (int)((long long)(chunk + 1) * n_rows / n_chunks) - r_beg;
  const int m_beg = (int)((long long)split * n_model / n_splits);
  const int m_cnt = (int)((long long)(split + 1) * n_model / n_splits) - m_beg;
  const float2* g_model = grouped + (size_t)b * (S + C);
  const float2* g_rows = g_model + C;
  const float2* rows = g_rows + row_off + r_beg;
  const float2* seg = g_model + (one ? 0 : pl[kM1]) + m_beg;
  float4* part = partial + ((size_t)b * max_splits + split) * S + row_off + r_beg;
  const float tx = st[0], ty = st[1], cth = st[2], sth = st[3];

  // m_cnt <= kSplit: the split goes to shared memory while the scene points load
  for (int k = tid; k < m_cnt; k += kMatchThreads) copy_async8(&tile[k], seg + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  dispatch_rows<kR>((r_cnt + kMatchThreads - 1) / kMatchThreads, [&](auto re) {
    constexpr int RE = decltype(re)::value;
    float qx[RE], qy[RE], rmin[RE], tsx[RE], tsy[RE], nt[RE];
#pragma unroll
    for (int j = 0; j < RE; ++j) {
      const bool have = j * kMatchThreads + tid < r_cnt;
      const float2 p = have ? rows[j * kMatchThreads + tid] : make_float2(0.f, 0.f);
      transform(p.x, p.y, tx, ty, cth, sth, qx[j], qy[j]);
      rmin[j] = have ? inlier_dist : -1.f;  // -1: no distance reaches it
      tsx[j] = tsy[j] = nt[j] = 0.f;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the split has arrived for every thread
    nearest_merge<RE>(tile, m_cnt, qx, qy, rmin, tsx, tsy, nt);
#pragma unroll
    for (int j = 0; j < RE; ++j) {
      if (j * kMatchThreads + tid < r_cnt)
        part[j * kMatchThreads + tid] = make_float4(rmin[j], tsx[j], tsy[j], nt[j]);
    }
  });

  // the block that finishes the robot's last item closes the iteration
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&pl[kDone], 1) == pl[kItems] - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  float acc[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.f;
  const float4* p0 = partial + (size_t)b * max_splits * S;
  const int n1 = pl[kN1], total = pl[kRows0] + pl[kN0];
  for (int r = tid; r < total; r += kMatchThreads) {
    const bool first = r < pl[kRows0];
    if (first && r >= n1) continue;  // a class-1 point while class 1 is off
    float rmin, tsx, tsy, nt, qx, qy;
    merge_splits(p0 + r, first ? pl[kNs1] : pl[kNs0], (size_t)S, inlier_dist, rmin, tsx, tsy,
                 nt);
    if (rmin < inlier_dist) {
      const float2 p = g_rows[r];
      transform(p.x, p.y, tx, ty, cth, sth, qx, qy);
      add_moments(acc, qx, qy, rmin, tsx, tsy, nt);
    }
  }
  block_sum<kMoments>(acc, red, tot);
  if (tid == 0) {
    float carry[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) carry[k] = st[k];
    pose_update(tot, carry, min_delta);
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = carry[k];
    write_out(out + 8 * (size_t)b, carry, 1.f);
    pl[kDone] = 0;
    if (iters != nullptr) atomicAdd(iters, 1ull);  // one iteration of a streamed fit
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Planes are contiguous (B, S) and
// (B, C) f32 with the classes of K1; init4 is (B, 4) [x, y, cos, sin]; out
// is (B, 8) [tx, ty, cos, sin, ok, ncorr, mres, delta]. Scratch, which the
// caller allocates and need not clear: state (B, 8) f32, plan (B, 12) i32,
// grouped (B, S + C, 2) f32, partial (B, ceil(C / 2048), S, 4) f32 (kSplit).
// iters, when not null, is one counter to which each robot adds the fit
// iterations it ran. Queues the set-up kernel and max_iter match launches on
// `stream` and returns the first cudaGetLastError() that is not 0.
extern "C" int slam_icp_tiled_planes(const float* sx, const float* sy, const float* sc,
                                     const float* mx, const float* my, const float* mc,
                                     const float* init4, float* out, float* state, int* plan,
                                     float* grouped, float* partial,
                                     unsigned long long* iters, int B, int S, int C,
                                     int max_iter, float inlier_dist, float min_delta,
                                     int min_scene, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  k3_setup<<<B, kSetupThreads, 0, st>>>(sx, sy, sc, mx, my, mc, init4, out, state, plan,
                                        (float2*)grouped, iters, S, C, max_iter,
                                        inlier_dist, min_delta, min_scene);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the most items a robot can have: its two classes round up apart
  const int max_splits = (C + kSplit - 1) / kSplit;
  const int max_chunks = (S + kChunk - 1) / kChunk + 1;
  const dim3 grid(max_chunks * (max_splits + 1), B);
  for (int it = 0; it < max_iter; ++it) {
    k3_match<<<grid, kMatchThreads, 0, st>>>(out, state, plan, (const float2*)grouped,
                                             (float4*)partial, iters, S, C, max_splits,
                                             inlier_dist, min_delta);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
