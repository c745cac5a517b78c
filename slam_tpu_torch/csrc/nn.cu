// K4: batched class-constrained 2D nearest neighbour, first minimum wins.
//
// Replaces: slam_tpu/ops/nn_pallas.py `_nn_kernel` (behind `_nn_batched`,
// `nearest_neighbor_pallas` and the `nearest_neighbor` dispatch), which the
// "points" matcher's `icp_fit` calls once per fit iteration.
//
// What bounds it on the card: arithmetic. A query needs the distance to
// every valid model point of its own class (5 f32 operations a pair; at the
// path's class mix about half of all S x C pairs); device memory carries
// only the queries, the model and the outputs. The TPU kernel formed an
// (R, S, C) distance tile in VMEM over all pairs, cross-class ones included;
// the first version here walked all C points for every query, three blocks
// a robot each staging the model, behind ~10 small PyTorch ops a call.
//
// What the design does about it:
// - One block a robot (and slice of at most `qchunk` queries) reads the
//   operands as they lie, every plane through its own strides: queries
//   (B, S, 2), model (B, C, k), the bool valid mask, the class planes
//   (bool, int or f32; none: unconstrained). No PyTorch op runs around it.
//   The queries and the model are read from device memory once, in one
//   pass, into shared memory; everything after works there.
// - The model is grouped by class, stably: warp ballots and a prefix over
//   the warps put class-1 points at the front of the tile in their order
//   and class-0 points at its back in reverse order (read backwards, again
//   in their order). Invalid points are dropped. Queries are grouped by
//   class too (their order does not matter), so a warp takes 32 * kRows
//   queries of one class and walks that class's segment only, each model
//   point read once from shared memory for R queries.
// - The walk keeps the running minimum with a strict `<` in the model's
//   order, so the first minimum wins, as in `jnp.argmin`. A model longer
//   than a tile is walked tile after tile in order, the running minimum kept
//   in shared memory between them.
// - A query for which every pair is cross-class or invalid (its class
//   empty in the model, or no class of the model's) gets the plain
//   version's answer at once: every pair gives fl(BIG + d2) >= BIG, so
//   when model point 0 gives BIG itself, index 0 and BIG are the first
//   minimum. The rest of such queries, and a query of another class than
//   0 and 1 where the model holds such classes, walk every point of the
//   tile with `BIG + d2` on invalid and cross-class pairs, as the plain
//   version does. (A same-class minimum that is not below BIG, which needs
//   coordinates beyond ~1e15, is walked again from device memory.)
//
// Rounding: d2 is `dx*dx + dy*dy` with each step rounded on its own (the
// file is built with -fmad=false), as the plain PyTorch version computes
// it. A same-class minimum below BIG is below every `BIG + d2` (>= BIG), so
// the grouped walk and the full walk pick the same point.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// queries a thread: one model point read from shared memory feeds kRows
// distances (1, 2 and 4 timed level on the H100)
constexpr int kRows = 1;
constexpr float kBig = 1e30f;

// Element strides (batch, point) of the seven planes, in argument order:
// qx, qy, qc, mx, my, mv, mc.
struct Strides {
  long long s[14];
};

// Class planes: 0 none (every point class 0), 1 f32, 2 bool. The value is
// the class as the plain version's f32 cast.
__device__ __forceinline__ float load_class(const void* p, int kind, long long off) {
  switch (kind) {
    case 1: return static_cast<const float*>(p)[off];
    case 2: return (float)static_cast<const unsigned char*>(p)[off];
    default: return 0.f;
  }
}

__device__ __forceinline__ float sqdist(float qx, float qy, float mx, float my) {
  const float dx = __fsub_rn(qx, mx);
  const float dy = __fsub_rn(qy, my);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

struct Args {
  const float *qx, *qy;
  const void* qc;
  const float *mx, *my;
  const unsigned char* mv;
  const void* mc;
  int *idx;
  float* dist;
  int S, C, qc_kind, mc_kind, tile, qchunk;
  Strides st;
};

// The model point k of robot b as the plain version sees it: its class, or
// 2 where it is invalid.
__device__ __forceinline__ float model_class(const Args& a, int b, int k) {
  const long long* s = a.st.s;
  const bool valid = !a.mv || a.mv[b * s[10] + k * s[11]];
  const float m = load_class(a.mc, a.mc_kind, b * s[12] + k * s[13]);
  return (!valid || m >= 2.f) ? 2.f : m;
}

// One warp's walk of its R queries a lane over n model points of a tile
// (p, in the model's order; `step` -1 walks a segment stored backwards).
// FULL: every point, `BIG + d2` on invalid (class 2) and cross-class
// pairs (classes pc), the index the tile position; else the segment of the
// queries' class, the index read from the segment's indices afterwards.
// best / bj: running minimum and its position, updated only by a strictly
// smaller distance.
template <int R, bool FULL>
__device__ __forceinline__ void walk(const float2* __restrict__ p, const float* __restrict__ pc,
                                     int step, int n, const float (&qx)[R],
                                     const float (&qy)[R], const float (&qc)[R],
                                     float (&best)[R], int (&bj)[R]) {
#pragma unroll 4
  for (int j = 0; j < n; ++j, p += step) {
    const float2 m = *p;
    float mc = 0.f;
    if (FULL) mc = pc[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d = sqdist(qx[r], qy[r], m.x, m.y);
      if (FULL && (mc >= 2.f || qc[r] != mc)) d = __fadd_rn(kBig, d);
      if (d < best[r]) {
        best[r] = d;
        bj[r] = j;
      }
    }
  }
}

// Loads model points [m0, m0 + tn) of robot b as they lie: coordinates and
// class (2: invalid).
__device__ __forceinline__ void load_tile(const Args& a, int b, int m0, int tn,
                                          float2* __restrict__ s_o, float* __restrict__ s_oc) {
  const long long* st = a.st.s;
  for (int i = threadIdx.x; i < tn; i += blockDim.x) {
    const int k = m0 + i;
    s_o[i] = make_float2(a.mx[b * st[6] + k * st[7]], a.my[b * st[8] + k * st[9]]);
    s_oc[i] = model_class(a, b, k);
  }
}

__global__ void __launch_bounds__(kThreads) nn_kernel(Args a) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.tile, Q = a.qchunk;
  float2* s_m = reinterpret_cast<float2*>(smem);       // T grouped model points
  float2* s_o = s_m + T;                                // T as they lie
  float2* s_q = s_o + T;                                // Q queries as they lie
  int* s_mi = reinterpret_cast<int*>(s_q + Q);          // T grouped points' indices
  float* s_oc = reinterpret_cast<float*>(s_mi + T);     // T classes as they lie
  float* s_qc = s_oc + T;                               // Q query classes
  int* s_perm = reinterpret_cast<int*>(s_qc + Q);       // Q queries by group
  float* s_best = reinterpret_cast<float*>(s_perm + Q); // Q running minima (by slot)
  int* s_bi = reinterpret_cast<int*>(s_best + Q);       // Q their indices
  __shared__ int s_w1[kWarps], s_w0[kWarps];
  __shared__ int s_cnt[2], s_put[3];

  const long long* st = a.st.s;
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * Q;
  const int nq = min(Q, a.S - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nt = kThreads, n_warps = kWarps;

  // one pass over device memory: the queries and the first model tile
  for (int i = tid; i < nq; i += nt) {
    const int q = q0 + i;
    s_q[i] = make_float2(a.qx[b * st[0] + q * st[1]], a.qy[b * st[2] + q * st[3]]);
    s_qc[i] = load_class(a.qc, a.qc_kind, b * st[4] + q * st[5]);
  }
  load_tile(a, b, 0, min(T, a.C), s_o, s_oc);
  __syncthreads();

  // valid model points of class 1, class 0 and any other class, in the
  // whole model (from shared memory when it is one tile)
  int all1 = 0, all0 = 0, allo = 0;
  for (int k0 = 0; k0 < a.C; k0 += nt) {
    const int k = k0 + tid;
    float m = 2.f;
    if (k < a.C) m = a.C <= T ? s_oc[k] : model_class(a, b, k);
    all1 += __syncthreads_count(m == 1.f);
    all0 += __syncthreads_count(m == 0.f);
    allo += __syncthreads_count(!(m >= 2.f) && m != 1.f && m != 0.f);
  }

  // queries by group: 0 class 1 and 1 class 0 (where the model holds that
  // class), 2 the full walk (another class the model may hold). A query
  // for which every pair is cross-class or invalid takes the plain
  // version's answer at once when fl(BIG + d2) of model point 0 is BIG,
  // the least value any pair can give: index 0, distance BIG.
  const float2 m0p = s_o[0];
  auto group = [&](int i) {
    const float qc = s_qc[i];
    if (qc == 1.f && all1 > 0) return 0;
    if (qc == 0.f && all0 > 0) return 1;
    if ((qc != 1.f && qc != 0.f && allo > 0) ||
        __fadd_rn(kBig, sqdist(s_q[i].x, s_q[i].y, m0p.x, m0p.y)) != kBig)
      return 2;
    return 3;
  };
  int c1 = 0, c0 = 0, cf = 0;
  for (int i0 = 0; i0 < nq; i0 += nt) {
    const int i = i0 + tid;
    const int g = i < nq ? group(i) : 4;
    if (g == 3) {
      const size_t o = (size_t)b * a.S + q0 + i;
      a.idx[o] = 0;
      a.dist[o] = kBig;
    }
    c1 += __syncthreads_count(g == 0);
    c0 += __syncthreads_count(g == 1);
    cf += __syncthreads_count(g == 2);
  }
  if (tid == 0) {
    s_put[0] = 0;
    s_put[1] = c1;
    s_put[2] = c1 + c0;
  }
  __syncthreads();
  // slots by warp: one atomic a warp and group
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = 0; i0 < nq; i0 += nt) {
    const int i = i0 + tid;
    const int g = i < nq ? group(i) : 4;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned ball = __ballot_sync(0xffffffffu, g == k);
      int base = 0;
      if (lane == 0 && ball) base = atomicAdd(&s_put[k], __popc(ball));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (g == k) {
        const int slot = base + __popc(ball & below);
        s_perm[slot] = i;
        s_best[slot] = INFINITY;
        s_bi[slot] = 0;
      }
    }
  }

  const int t1 = (c1 + 32 * R - 1) / (32 * R);
  const int t0 = (c0 + 32 * R - 1) / (32 * R);
  const int tf = (cf + 32 * R - 1) / (32 * R);
  for (int m0 = 0; m0 < a.C; m0 += T) {
    const int tn = min(T, a.C - m0);
    if (m0 > 0) {
      __syncthreads();
      load_tile(a, b, m0, tn, s_o, s_oc);
    }
    // group the tile by class: class 1 from the front, class 0 from the
    // back, each in the model's order
    if (tid == 0) s_cnt[0] = s_cnt[1] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < tn; i0 += nt) {
      const int i = i0 + tid;
      const float m = i < tn ? s_oc[i] : 2.f;
      const unsigned b1 = __ballot_sync(0xffffffffu, m == 1.f);
      const unsigned b0 = __ballot_sync(0xffffffffu, m == 0.f);
      if (lane == 0) {
        s_w1[warp] = __popc(b1);
        s_w0[warp] = __popc(b0);
      }
      __syncthreads();
      int o1 = s_cnt[0], o0 = s_cnt[1], n1 = 0, n0 = 0;
      for (int w = 0; w < n_warps; ++w) {
        if (w == warp) {
          o1 += n1;
          o0 += n0;
        }
        n1 += s_w1[w];
        n0 += s_w0[w];
      }
      if (m == 1.f || m == 0.f) {
        const int slot = m == 1.f ? o1 + __popc(b1 & below) : T - 1 - (o0 + __popc(b0 & below));
        s_m[slot] = s_o[i];
        s_mi[slot] = m0 + i;
      }
      __syncthreads();
      if (tid == 0) {
        s_cnt[0] += n1;
        s_cnt[1] += n0;
      }
    }
    __syncthreads();
    const int m1 = s_cnt[0], mz = s_cnt[1];

    // a warp a task of up to 32 R queries of one group
    for (int task = warp; task < t1 + t0 + tf; task += n_warps) {
      const int g = task < t1 ? 0 : (task < t1 + t0 ? 1 : 2);
      const int t = task - (g == 0 ? 0 : (g == 1 ? t1 : t1 + t0));
      const int beg = (g == 0 ? 0 : (g == 1 ? c1 : c1 + c0)) + t * 32 * R;
      const int cnt = min(32 * R, (g == 0 ? c1 : (g == 1 ? c0 : cf)) - t * 32 * R);
      float qx[R], qy[R], qc[R], best[R];
      int bj[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        const int i = j < cnt ? s_perm[beg + j] : 0;
        qx[r] = j < cnt ? s_q[i].x : 0.f;
        qy[r] = j < cnt ? s_q[i].y : 0.f;
        qc[r] = j < cnt ? s_qc[i] : -1.f;
        best[r] = j < cnt ? s_best[beg + j] : INFINITY;
        bj[r] = -1;
      }
      if (g == 2)
        walk<R, true>(s_o, s_oc, 1, tn, qx, qy, qc, best, bj);
      else if (g == 0)
        walk<R, false>(s_m, nullptr, 1, m1, qx, qy, qc, best, bj);
      else
        walk<R, false>(s_m + (T - 1), nullptr, -1, mz, qx, qy, qc, best, bj);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        if (j < cnt && bj[r] >= 0) {
          s_best[beg + j] = best[r];
          s_bi[beg + j] = g == 2 ? m0 + bj[r] : s_mi[g == 0 ? bj[r] : T - 1 - bj[r]];
        }
      }
    }
  }
  __syncthreads();

  // a same-class minimum that is not below BIG (coordinates beyond ~1e15):
  // the full walk from device memory; then every query's result goes out
  for (int slot = tid; slot < c1 + c0 + cf; slot += nt) {
    const int i = s_perm[slot];
    float best = s_best[slot];
    int bi = s_bi[slot];
    if (slot < c1 + c0 && !(best < kBig)) {
      const float2 q = s_q[i];
      const float qc = s_qc[i];
      best = INFINITY;
      bi = 0;
      for (int k = 0; k < a.C; ++k) {
        const float m = model_class(a, b, k);
        float d = sqdist(q.x, q.y, a.mx[b * st[6] + k * st[7]], a.my[b * st[8] + k * st[9]]);
        if (m >= 2.f || qc != m) d = __fadd_rn(kBig, d);
        if (d < best) {
          best = d;
          bi = k;
        }
      }
    }
    const size_t o = (size_t)b * a.S + q0 + i;
    a.idx[o] = bi;
    a.dist[o] = best;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). qx, qy: (B, S) f32 query planes;
// qc: (B, S) query classes or null; mx, my: (B, C) f32 model planes; mv:
// (B, C) bool validity or null (all valid); mc: (B, C) model classes (2 and
// above: invalid) or null; the class planes' types are qc_kind / mc_kind
// (0 none, 1 f32, 2 bool). strides: 14 element strides,
// (batch, point) of each plane in that order. idx (B, S) int32 and dist
// (B, S) f32 are written. tile: model points staged at once; qchunk:
// queries a block. Returns cudaGetLastError().
extern "C" int slam_nn(const float* qx, const float* qy, const void* qc, const float* mx,
                       const float* my, const unsigned char* mv, const void* mc, int* idx,
                       float* dist, int B, int S, int C, int qc_kind, int mc_kind,
                       const long long* strides, int tile, int qchunk, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  Args a{qx, qy, qc, mx, my, mv, mc, idx, dist, S, C, qc_kind, mc_kind, tile, qchunk, {}};
  for (int i = 0; i < 14; ++i) a.st.s[i] = strides[i];
  const size_t smem = (size_t)24 * tile + (size_t)24 * qchunk;
  const dim3 grid(B, (S + qchunk - 1) / qchunk);
  if (smem + 1024 > 48 * 1024) {  // with the static part, above the default limit
    const cudaError_t e =
        cudaFuncSetAttribute(nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
