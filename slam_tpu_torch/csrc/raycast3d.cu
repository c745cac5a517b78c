// The 3D simulator's raycast (sim/world3d.py `raycast` on the card): each
// ray of each robot's ring scan meets the sine terrain (a march that
// brackets the first crossing of the height margin, then regula falsi) or
// the nearest cylinder wall within its height.
//
// Replaces no TPU kernel: slam_tpu/sim/world3d.py `raycast` is plain XLA,
// and the port's plain version (`raycast_reference`) materialises the march
// and the cylinder tests as (B, N, T) and (B, N, M) tensors, 0.85-1.14 GB
// each at the HDL-32E fleet's shapes (B = 64, N = 69,440, T = 16, M = 48),
// written to device memory and read back, and finds the first crossing with
// an int64 cumsum over every ray's samples.
//
// What bounds it on the card: arithmetic. A ray needs at most T march
// samples and refine_steps regula falsi samples of a K-sine terrain (K
// precise sinf each) and M circle tests; its output is a point and a hit
// flag. At the fleet's shapes that is ~17 G instructions against ~75 MB
// of directions, noise and output.
//
// What the design does about it: one thread a ray, a block 256 rays of one
// robot (grid: ray blocks x robots). The block stages the terrain, the
// march's sample distances and its robot's cylinder terms (oc, c_term, the
// terrain under each centre and that plus the height) in shared memory. The
// march runs in registers and stops at the first crossing, where the plain
// version's `cumsum == 1` mask picks the same bracket; regula falsi runs
// only where a crossing exists (elsewhere the plain version discards its
// result), in the same loop as the march, so that a warp's rays sample the
// terrain together whichever phase each is in. The cylinder loop keeps the
// least valid t. Nothing of size (B, N, T) or (B, N, M) reaches device
// memory.
//
// Rounding: every product and sum is one IEEE-rounded operation in the
// plain version's order on the card (__fmul_rn / __fadd_rn, and the file is
// built with -fmad=false): arg = (x*ax + y*ay) + phase; the terrain's K
// terms summed in the order torch.sum(-1) reduces a contiguous row of K on
// the card (lane x of last_pow2(K) lanes sums terms x, x + lanes, ...; the
// lanes then fold with halving offsets: (v0 + v2) + (v1 + v3) for K = 4);
// b_half as the batched matrix product computes it, one fused multiply-add
// onto the rounded first product; sinf and sqrtf precise, divisions IEEE.
// The ray directions, the march's distances (torch.linspace), the sensor
// origins and the range noise come from the wrapper, so the scan equals the
// plain version's but for grazing rays (a margin or discriminant within a
// few ulps of 0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // rays a block, all of one robot
constexpr int kMaxWaves = 8;    // terrain sines the kernel takes

// The terrain's height at (x, y): K <= 8 terms amp * sin((x*ax + y*ay) +
// phase) (w[k] = (ax, ay, phase, amp)) summed in the order torch.sum(-1)
// reduces a contiguous row of K on the card: last_pow2(K) lanes, lane x
// summing terms x and x + lanes, folded with halving offsets. For every
// K <= 8 that is ((v0 + v4) + (v2 + v6)) + ((v1 + v5) + (v3 + v7)) with
// the absent terms left out: (v0 + v2) + (v1 + v3) for K = 4.
__device__ __forceinline__ float terrain_at(const float4* __restrict__ w, int K, float x,
                                           float y) {
  float v[kMaxWaves];
#pragma unroll
  for (int k = 0; k < kMaxWaves; ++k) {
    v[k] = 0.f;
    if (k < K) {
      const float4 p = w[k];
      const float arg = __fadd_rn(__fadd_rn(__fmul_rn(x, p.x), __fmul_rn(y, p.y)), p.z);
      v[k] = __fmul_rn(p.w, sinf(arg));
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k + 4 < K) v[k] = __fadd_rn(v[k], v[k + 4]);
  }
  const float a = K > 2 ? __fadd_rn(v[0], v[2]) : v[0];
  const float b = K > 3 ? __fadd_rn(v[1], v[3]) : v[1];
  return K > 1 ? __fadd_rn(a, b) : a;
}

// The height margin of the ray's point o + t * d above the terrain.
__device__ __forceinline__ float margin(const float4* __restrict__ w, int K, float ox, float oy,
                                       float oz, float dx, float dy, float dz, float t) {
  const float px = __fadd_rn(ox, __fmul_rn(t, dx));
  const float py = __fadd_rn(oy, __fmul_rn(t, dy));
  const float pz = __fadd_rn(oz, __fmul_rn(t, dz));
  return __fsub_rn(pz, terrain_at(w, K, px, py));
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// The regula falsi point of the bracket [lo, hi] with margins m_lo, m_hi.
__device__ __forceinline__ float falsi(float lo, float hi, float m_lo, float m_hi) {
  const float den = clamp_min(__fsub_rn(m_lo, m_hi), 1e-12f);
  return __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fsub_rn(hi, lo), m_lo), den));
}

// torch.minimum: NaN if either is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

struct Cylinder {
  float ocx, ocy, c_term, ground, top;
};

__global__ void __launch_bounds__(kThreads)
raycast3d_kernel(const float* __restrict__ d, long long d_b, long long d_n, long long d_c,
                 const float* __restrict__ d_local, const float* __restrict__ origin,
                 const float* __restrict__ ts, const float* __restrict__ centers,
                 const float* __restrict__ radii, const float* __restrict__ heights,
                 const float* __restrict__ terrain, const float* __restrict__ noise,
                 float* __restrict__ points, unsigned char* __restrict__ hit, int N, int T, int M,
                 int K, int refine_steps, float tmax, float range_noise) {
  extern __shared__ __align__(16) float smem[];
  float4* s_w = reinterpret_cast<float4*>(smem);
  Cylinder* s_cyl = reinterpret_cast<Cylinder*>(smem + 4 * K);
  float* s_ts = smem + 4 * K + 5 * M;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 4 * K; i += kThreads) smem[i] = terrain[i];
  for (int i = threadIdx.x; i < T; i += kThreads) s_ts[i] = ts[i];
  const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const float cx = centers[2 * m], cy = centers[2 * m + 1], r = radii[m];
    Cylinder c;
    c.ocx = __fsub_rn(ox, cx);
    c.ocy = __fsub_rn(oy, cy);
    c.c_term = __fsub_rn(__fadd_rn(__fmul_rn(c.ocx, c.ocx), __fmul_rn(c.ocy, c.ocy)),
                         __fmul_rn(r, r));
    c.ground = terrain_at(s_w, K, cx, cy);
    c.top = __fadd_rn(c.ground, heights[m]);
    s_cyl[m] = c;
  }
  __syncthreads();
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* dp = d + b * d_b + n * d_n;
  const float dx = dp[0], dy = dp[d_c], dz = dp[2 * d_c];

  // terrain: march to the first sample whose margin is not above 0 after
  // one that is, then refine_steps of regula falsi in that bracket. One
  // loop takes both, so a warp's rays evaluate the terrain together
  // whichever phase each is in. While marching, (lo, m_lo) is the last
  // sample.
  float t_terr = INFINITY;
  float lo = 0.f, hi = 0.f, m_lo = 0.f, m_hi = 0.f;
  int k = 0;    // the next march sample
  int s = -1;   // regula falsi steps taken, -1 while marching
  while (true) {
    float t;
    if (s < 0) {
      if (k == T) break;
      t = s_ts[k];
    } else if (s < refine_steps) {
      t = falsi(lo, hi, m_lo, m_hi);
    } else {
      t_terr = falsi(lo, hi, m_lo, m_hi);
      break;
    }
    const float mt = margin(s_w, K, ox, oy, oz, dx, dy, dz, t);
    if (s >= 0) {
      if (mt > 0.f) {
        lo = t;
        m_lo = mt;
      } else {
        hi = t;
        m_hi = mt;
      }
      ++s;
    } else if (k > 0 && m_lo > 0.f && !(mt > 0.f)) {   // the first crossing
      hi = t;
      m_hi = mt;
      s = 0;
    } else {
      lo = t;
      m_lo = mt;
      ++k;
    }
  }

  // cylinders: the circle in xy, then the wall's height range
  const float a = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float a_c = clamp_min(a, 1e-9f);
  float t_cyl = INFINITY;
  for (int m = 0; m < M; ++m) {
    const Cylinder c = s_cyl[m];
    const float b_half = __fmaf_rn(dy, c.ocy, __fmul_rn(dx, c.ocx));
    const float disc = __fsub_rn(__fmul_rn(b_half, b_half), __fmul_rn(a, c.c_term));
    const float tc = __fdiv_rn(__fsub_rn(-b_half, __fsqrt_rn(clamp_min(disc, 0.f))), a_c);
    const float pz = __fadd_rn(oz, __fmul_rn(tc, dz));
    if (disc > 0.f && tc > 1e-3f && pz > c.ground && pz < c.top && tc < t_cyl) t_cyl = tc;
  }

  float t = nan_min(t_terr, t_cyl);
  const bool h = !isinf(t) && !isnan(t) && t < tmax;
  t = h ? t : tmax;
  const size_t r = (size_t)b * N + n;
  if (noise != nullptr) t = __fadd_rn(t, __fmul_rn(range_noise, noise[r]));
  const float* dl = d_local + 3 * (size_t)n;
  points[3 * r] = __fmul_rn(t, dl[0]);
  points[3 * r + 1] = __fmul_rn(t, dl[1]);
  points[3 * r + 2] = __fmul_rn(t, dl[2]);
  hit[r] = h;
}

}  // namespace

// slam_raycast3d: d (B, N, 3) world-frame ray directions at element strides
// (d_b, d_n, d_c); d_local (N, 3) the sensor-frame pattern; origin (B, 3)
// sensor positions; ts (T,) the march's distances; centers (M, 2), radii
// (M,), heights (M,) the cylinders; terrain (K, 4) rows (ax, ay, phase,
// amp), K <= 8; noise (B, N) standard normal or null; out points (B, N, 3)
// and hit (B, N) bool bytes. All f32 but hit, contiguous but d. smem is the
// dynamic shared memory the block stages: 4 * (4K + 5M + T) bytes.
extern "C" int slam_raycast3d(const float* d, long long d_b, long long d_n, long long d_c,
                              const float* d_local, const float* origin, const float* ts,
                              const float* centers, const float* radii, const float* heights,
                              const float* terrain, const float* noise, float* points,
                              unsigned char* hit, int B, int N, int T, int M, int K,
                              int refine_steps, float tmax, float range_noise, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (K < 1 || K > kMaxWaves || B > 65535) return (int)cudaErrorInvalidValue;
  const int smem = 4 * (4 * K + 5 * M + T);
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raycast3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  raycast3d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      d, d_b, d_n, d_c, d_local, origin, ts, centers, radii, heights, terrain, noise, points, hit,
      N, T, M, K, refine_steps, tmax, range_noise);
  return (int)cudaGetLastError();
}
