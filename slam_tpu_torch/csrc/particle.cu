// K5: particle scoring for the particle-filter matcher. For each robot and
// each of its P particles, the fraction of the robot's valid scan points
// whose cell in the (G, G) occupancy table is occupied.
//
// Replaces: slam_tpu/ops/particle.py `_pf_scores_pallas` (its inner
// `kernel`, reached from `score_particles` with scorer "pallas", or "auto"
// on a TPU), which `pf_match` calls twice per tick: once for the P
// proposals and once (P = 1) to re-score the returned pose.
//
// What bounds it on the card: neither bytes nor arithmetic at config 5's
// shapes (B = 1024, N = 96 of a 384-point scan, P = 128, G = 192): ~1 MB of
// scan, particles and fractions, one 147 KB count grid, and ~12.6 M lookups;
// both bounds are a microsecond or two, below a launch. What held the first
// version back was around the kernel: ~13 small PyTorch ops a call (a byte
// table, copies of the strided scan, the stacked particles, cos / sin and
// the division by the valid count), and each of its 1,024 blocks staging the
// whole 36 KB byte table for 96 lookups a particle.
//
// What the design does about it:
// - pf_pack_kernel packs the count grid into a bit table once per
//   `pf_match` (4,608 bytes at G = 192: one bit a cell, cell (ix, iy) at bit
//   ix * G + iy of the robot's row of 32-bit words; count > 0, so a NaN
//   count, the mark of a misaligned merge, is not occupied). A warp ballot
//   makes each word; both scoring calls of the match read the same table.
// - pf_score_kernel reads pf_match's tensors as they lie (the (B, N_full, 3)
//   scan and its mask at the score stride, the particles, the centre: every
//   operand through its own strides) and writes the fractions. One block a
//   robot stages the bit table and the robot's valid points, compacted, in
//   shared memory; one thread a particle walks them (a broadcast read a
//   point) and counts hits as integers: no reduction.
// - pf_score_warp_kernel is the P = 1 re-score's shape: one warp a robot,
//   lanes over the points, the bit table read through the L1 cache (4.6 KB,
//   one for the whole fleet), no staging, a shuffle sum.
// - cos and sin of each yaw are computed in the kernel with cosf / sinf,
//   the functions torch.cos / torch.sin run on the card (chip_smoke.py holds
//   the hit counts equal to the plain version's).
//
// Rounding: every step is one IEEE-rounded operation in the plain version's
// order: se2_apply (c*x - s*y + px), minus the grid centre, times the scale,
// then floor. The scale is the f32 reciprocal of the resolution, which is
// what PyTorch computes on the card for `tensor / python_float` (a multiply
// by the reciprocal); for a power-of-two resolution it equals the CPU's
// division bit for bit. The valid count is an exact integer and the fraction
// one __fdiv_rn. The file is built with -fmad=false, so the kernel equals
// its plain PyTorch version exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // pf_score_kernel: one thread a particle
constexpr int kWarpThreads = 256;  // pf_score_warp_kernel: 8 robots a block
constexpr int kPackThreads = 256;

// Element strides of the scoring operands (B, N, 2) scan view, (B, N) mask
// view, (B, P, 3) particles, (Bg, 2) centre.
struct Layout {
  long long scan_b, scan_n, scan_c;
  long long valid_b, valid_n;
  long long part_b, part_p, part_c;
  long long center_b, center_c;
};

__global__ void __launch_bounds__(kPackThreads)
pf_pack_kernel(const float* __restrict__ count, long long cb, long long cx, long long cy,
               int Bg, int G, int W, unsigned* __restrict__ bits) {
  const long long t = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  const long long total = (long long)Bg * W * 32;
  if (t - (threadIdx.x & 31) >= total) return;  // whole warps only
  const int b = (int)(t / ((long long)W * 32));
  const int cell = (int)(t - (long long)b * W * 32);
  bool occ = false;
  if (t < total && cell < G * G) {
    const int ix = cell / G, iy = cell - ix * G;
    occ = count[b * cb + ix * cx + iy * cy] > 0.f;
  }
  const unsigned word = __ballot_sync(0xffffffffu, occ);
  if ((threadIdx.x & 31) == 0 && t < total) bits[(size_t)b * W + cell / 32] = word;
}

// Hit test of one scan point (x, y) under a particle: the plain version's
// arithmetic, then one bit of the table.
__device__ __forceinline__ int hit(const unsigned* __restrict__ tab, float x, float y, float px,
                                   float py, float c, float s, float cx0, float cy0,
                                   float scale, int G) {
  const float wx = __fadd_rn(__fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y)), px);
  const float wy = __fadd_rn(__fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y)), py);
  const float fx = floorf(__fmul_rn(__fsub_rn(wx, cx0), scale));
  const float fy = floorf(__fmul_rn(__fsub_rn(wy, cy0), scale));
  // in bounds: the floors are whole floats, so comparing them with the
  // grid's edges in f32 is exact, and the plain version's int32 cast of
  // anything outside (far off the grid, or saturated) lands outside too;
  // NaN fails the compares
  const float lo = (float)(-(G / 2)), hi = (float)(G - G / 2);
  if (!(fx >= lo && fx < hi && fy >= lo && fy < hi)) return 0;
  const int k = ((int)fx + G / 2) * G + ((int)fy + G / 2);
  return (tab[k >> 5] >> (k & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
pf_score_kernel(const unsigned* __restrict__ bits, int W, int G, int shared_table,
                const float* __restrict__ center, const float* __restrict__ scan,
                const unsigned char* __restrict__ valid, const float* __restrict__ parts,
                float* __restrict__ out, int N, int P, float scale, Layout L) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* s_tab = smem;
  float2* s_pt = reinterpret_cast<float2*>(smem + ((W + 1) & ~1));
  __shared__ int s_n;
  const int b = blockIdx.x;
  const int tb = shared_table ? 0 : b;
  const unsigned* tab = bits + (size_t)tb * W;
  for (int i = threadIdx.x; i < W; i += kThreads) s_tab[i] = tab[i];
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  // compact the valid points (their order does not change a count)
  for (int i0 = 0; i0 < N; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool v = i < N && valid[b * L.valid_b + i * L.valid_n] != 0;
    const unsigned ball = __ballot_sync(0xffffffffu, v);
    int base = 0;
    if ((threadIdx.x & 31) == 0 && ball) base = atomicAdd(&s_n, __popc(ball));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (v) {
      const float* q = scan + b * L.scan_b + i * L.scan_n;
      s_pt[base + __popc(ball & ((1u << (threadIdx.x & 31)) - 1u))] =
          make_float2(q[0], q[L.scan_c]);
    }
  }
  __syncthreads();
  const int n = s_n;
  const float cx0 = center[tb * L.center_b], cy0 = center[tb * L.center_b + L.center_c];
  const float denom = (float)max(n, 1);
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float* q = parts + b * L.part_b + p * L.part_p;
    const float px = q[0], py = q[L.part_c], yaw = q[2 * L.part_c];
    const float c = cosf(yaw), s = sinf(yaw);
    int h = 0;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float2 pt = s_pt[i];
      h += hit(s_tab, pt.x, pt.y, px, py, c, s, cx0, cy0, scale, G);
    }
    out[(size_t)b * P + p] = __fdiv_rn((float)h, denom);
  }
}

__global__ void __launch_bounds__(kWarpThreads)
pf_score_warp_kernel(const unsigned* __restrict__ bits, int W, int G, int shared_table,
                     const float* __restrict__ center, const float* __restrict__ scan,
                     const unsigned char* __restrict__ valid, const float* __restrict__ parts,
                     float* __restrict__ out, int B, int N, int P, float scale, Layout L) {
  const int b = blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int lane = threadIdx.x & 31;
  const int tb = shared_table ? 0 : b;
  const unsigned* tab = bits + (size_t)tb * W;
  const float cx0 = center[tb * L.center_b], cy0 = center[tb * L.center_b + L.center_c];
  for (int p = 0; p < P; ++p) {
    const float* q = parts + b * L.part_b + p * L.part_p;
    const float px = q[0], py = q[L.part_c], yaw = q[2 * L.part_c];
    const float c = cosf(yaw), s = sinf(yaw);
    int h = 0, n = 0;
    // every load of an iteration is in flight before its mask decides
#pragma unroll 4
    for (int i = lane; i < N; i += 32) {
      const bool v = valid[b * L.valid_b + i * L.valid_n] != 0;
      const float* pt = scan + b * L.scan_b + i * L.scan_n;
      const float x = pt[0], y = pt[L.scan_c];
      n += v;
      if (v) h += hit(tab, x, y, px, py, c, s, cx0, cy0, scale, G);
    }
    for (int off = 16; off > 0; off >>= 1) {
      h += __shfl_down_sync(0xffffffffu, h, off);
      n += __shfl_down_sync(0xffffffffu, n, off);
    }
    if (lane == 0) out[(size_t)b * P + p] = __fdiv_rn((float)h, (float)max(n, 1));
  }
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns cudaGetLastError().
//
// slam_pf_pack: count (Bg, G, G) f32 at element strides (cb, cx, cy) ->
// bits (Bg, W) 32-bit words, W = ceil(G * G / 32).
extern "C" int slam_pf_pack(const float* count, long long cb, long long cx, long long cy, int Bg,
                            int G, unsigned* bits, void* stream) {
  if (Bg <= 0 || G <= 0) return 0;
  const int W = (G * G + 31) / 32;
  const long long threads = (long long)Bg * W * 32;
  const unsigned blocks = (unsigned)((threads + kPackThreads - 1) / kPackThreads);
  pf_pack_kernel<<<blocks, kPackThreads, 0, (cudaStream_t)stream>>>(count, cb, cx, cy, Bg, G, W,
                                                                   bits);
  return (int)cudaGetLastError();
}

// slam_pf_score: bits (1 or B, W) from slam_pf_pack; center (1 or B, 2),
// scan view (B, N, 2), valid view (B, N) bool bytes, particles (B, P, 3)
// f32 [x, y, yaw], each at the element strides of `layout` (10 values, in
// the order of struct Layout); out (B, P) f32 fractions. warp = 1 takes one
// warp a robot (the shape for few particles); smem is the bytes the block
// kernel stages (bit table and N points).
extern "C" int slam_pf_score(const unsigned* bits, int G, int shared_table, const float* center,
                             const float* scan, const unsigned char* valid, const float* parts,
                             float* out, int B, int N, int P, float scale,
                             const long long* layout, int warp, int smem, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const int W = (G * G + 31) / 32;
  Layout L;
  long long* f = &L.scan_b;
  for (int i = 0; i < 10; ++i) f[i] = layout[i];
  if (warp) {
    const int per = kWarpThreads / 32;
    pf_score_warp_kernel<<<(B + per - 1) / per, kWarpThreads, 0, (cudaStream_t)stream>>>(
        bits, W, G, shared_table, center, scan, valid, parts, out, B, N, P, scale, L);
    return (int)cudaGetLastError();
  }
  if (smem + 1024 > 48 * 1024) {  // with the static part, above the default limit
    const cudaError_t e = cudaFuncSetAttribute(
        pf_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  pf_score_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      bits, W, G, shared_table, center, scan, valid, parts, out, N, P, scale, L);
  return (int)cudaGetLastError();
}
