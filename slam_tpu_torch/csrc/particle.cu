// K5: particle scoring for the particle-filter matcher. For each robot and
// each of its P particles, count the valid scan points whose cell in the
// (G, G) occupancy table is occupied.
//
// Replaces: slam_tpu/ops/particle.py `_pf_scores_pallas` (its inner
// `kernel`, reached from `score_particles` with scorer "pallas", or "auto"
// on a TPU), which `pf_match` calls twice per tick: once for the P
// proposals and once (P = 1) to re-score the returned pose.
//
// What bounds it on the card: neither bytes nor arithmetic at config 5's
// shapes (B = 1024, N = 96, P = 128, G = 192): ~3.5 MB of scan, particles
// and hit counts plus one 36 KB table, and ~12.6 M lookups; both bounds
// are a microsecond or two, below a launch. In practice each block's
// staging of its table into shared memory (G * G bytes) and its
// shared-memory lookups bound it.
//
// What the design does about it: the TPU kernel built two bf16 one-hot
// matrices per particle chunk and multiplied them through the table,
// because TPU gathers serialize. Here the table is a direct lookup: one
// block per robot stages the robot's byte table (or the fleet's shared one:
// batch stride 0) and its N scan points in shared memory; each warp takes a
// particle at a time, its lanes stride over the points and count hits as
// integers, and a __shfl_down_sync reduction sums them. The count is
// written as an exact f32 integer.
//
// Rounding: cos and sin of each particle's yaw come from the wrapper (the
// same torch.cos / torch.sin the plain version uses), and every step below
// is one IEEE-rounded operation in score_pose's order: se2_apply
// (c*x - s*y + px), minus the grid centre, divided (not multiplied by the
// inverse) by the resolution, then floor. The file is built with
// -fmad=false, so the kernel equals its plain PyTorch version exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
pf_hits_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
               const unsigned char* __restrict__ valid,
               const float* __restrict__ parts,
               const unsigned char* __restrict__ occ,
               const float* __restrict__ center, float* __restrict__ hits,
               int N, int P, int G, float res, int shared_table) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int GG = G * G;
  const int occ_bytes = (GG + 15) & ~15;
  unsigned char* s_occ = smem;
  float* s_x = reinterpret_cast<float*>(smem + occ_bytes);
  float* s_y = s_x + N;
  unsigned char* s_v = reinterpret_cast<unsigned char*>(s_y + N);

  const int b = blockIdx.x;
  const unsigned char* tab = occ + (shared_table ? 0 : (size_t)b * GG);
  if ((GG & 15) == 0 && (reinterpret_cast<uintptr_t>(tab) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(tab);
    uint4* dst = reinterpret_cast<uint4*>(s_occ);
    for (int i = threadIdx.x; i < GG / 16; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < GG; i += kThreads) s_occ[i] = tab[i];
  }
  const size_t so = (size_t)b * N;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    s_x[i] = sx[so + i];
    s_y[i] = sy[so + i];
    s_v[i] = valid[so + i];
  }
  __syncthreads();

  const float* ctr = center + (shared_table ? 0 : 2 * b);
  const float cx0 = ctr[0], cy0 = ctr[1];
  const int half = G / 2;
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x / 32; p < P; p += kWarps) {
    const float* q = parts + ((size_t)b * P + p) * 4;
    const float px = q[0], py = q[1], c = q[2], s = q[3];
    int n = 0;
    for (int i = lane; i < N; i += 32) {
      if (!s_v[i]) continue;
      const float x = s_x[i], y = s_y[i];
      const float wx = __fadd_rn(__fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y)), px);
      const float wy = __fadd_rn(__fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y)), py);
      const float fx = floorf(__fdiv_rn(__fsub_rn(wx, cx0), res));
      const float fy = floorf(__fdiv_rn(__fsub_rn(wy, cy0), res));
      // far off the grid (or NaN): out of bounds, like the plain version's
      // int32 cast; in range the cast of a floor is exact
      if (!(fabsf(fx) < 1e9f) || !(fabsf(fy) < 1e9f)) continue;
      const int ix = (int)fx + half, iy = (int)fy + half;
      if (ix < 0 || iy < 0 || ix >= G || iy >= G) continue;
      n += s_occ[ix * G + iy] != 0;
    }
    for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
    if (lane == 0) hits[(size_t)b * P + p] = (float)n;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). sx, sy: (B, N) f32 scan planes;
// valid: (B, N) bool bytes; parts: (B, P, 4) f32 [x, y, cos, sin]; occ:
// (B, G, G) bytes, or (1, G, G) with shared_table = 1; center: (B, 2) f32,
// or (1, 2) when shared; hits: (B, P) f32 out. Returns cudaGetLastError().
extern "C" int slam_pf_hits(const float* sx, const float* sy, const unsigned char* valid,
                            const float* parts, const unsigned char* occ, const float* center,
                            float* hits, int B, int N, int P, int G, float res,
                            int shared_table, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const size_t smem = (size_t)(((G * G) + 15) & ~15) + (size_t)9 * N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pf_hits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pf_hits_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      sx, sy, valid, parts, occ, center, hits, N, P, G, res, shared_table);
  return (int)cudaGetLastError();
}
