// GP-INSAC's sector stage of ground segmentation (ops/ground.py
// `gp_sectors` on the card): each robot's sector sorts its range bins'
// prototypes by height, takes the lowest as seeds, and grows a Gaussian
// process ground model sweep by sweep, adopting every inlier at once; the
// bins' table that the points gather from is its output.
//
// Replaces no TPU kernel: slam_tpu/ops/ground.py's sweeps are plain XLA (an
// unrolled Cholesky in lax.scan). The port's plain version
// (`gp_sectors_reference`) runs every sweep as batched library calls over
// all robots x sectors: a (B, S, C, C) system built from masked products,
// cuSOLVER's batched Cholesky and a 65-column triangular solve, about 60
// launches a sweep, and every sweep in full even for sectors that stopped
// adopting. At the HDL-32E fleet's shapes (B = 64, S = 72, L = 200,
// C = 64, 10 sweeps) that is ~600 launches and ~22 ms a call on an H100.
//
// What bounds it on the card: the dependent chains of one small problem.
// A sweep on n model slots factors n x n (n^3 / 3 operations) and
// substitutes C + 1 columns ((C + 1) n^2): at most ~20 GFLOP a call at the
// fleet's shapes, 0.3 ms at the H100's f32 rate, against ~11 MB of
// prototypes in and ~19 MB of table, masks and heights out. One sector's
// system is at most 16 KB.
//
// What the design does about it: one block a (robot, sector), everything
// in shared memory and registers, nothing but the inputs and the outputs in
// device memory. The block ranks its L bins by height (the stable argsort's
// order: invalid bins last, ties by bin index) and keeps the first C as
// slots; picks the seeds; then runs the sweeps in a loop that ends when the
// sector stops adopting (the plain version keeps such a sector's f_s, so
// the results are the same). Rows and columns of the plain version's
// system outside the model are the identity, and their right-hand sides
// exact zeros, so each sweep factors and substitutes the model's slots
// alone, compacted in slot order: n^3 / 3 for n model slots, not C^3 / 3.
// The factor is right-looking, a thread a row (column-major storage, so a
// warp's rows are neighbouring words); the substitution a thread a column:
// column 0 the model's heights, column c + 1 the kernel between slot c and
// the model. The squared-exponential kernel is recomputed where it is
// needed (a precise expf an entry) rather than stored.
//
// Rounding: the kernel's entries as the plain version rounds them on the
// card: d = r_i - r_j; signal_var * expf(-(d * d) * inv_two_l2) with
// inv_two_l2 the f32 reciprocal of 2 l^2 (PyTorch's division by a scalar
// on the card); the diagonal (k + noise). The factor, the substitution and
// the sums of f and v take fused multiply-adds in their own order; the
// plain version's cuSOLVER and cuBLAS round theirs in another, so f_s
// agrees to rounding and an inlier test at its gate can flip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 128;
constexpr int kMaxThreads = 160;   // a thread a substitution column: C + 1

struct GpParams {
  float min_bin_points, seed_max_range, seed_max_height;
  float signal_var, inv_two_l2, noise, model_conf, data_conf;
  int num_seed_points, sweeps;
};

__device__ __forceinline__ float se_kernel(float a, float b, const GpParams& p) {
  const float d = __fsub_rn(a, b);
  return __fmul_rn(p.signal_var, expf(__fmul_rn(-__fmul_rn(d, d), p.inv_two_l2)));
}

__global__ void __launch_bounds__(kMaxThreads)
ground_gp_kernel(const float* __restrict__ count, const float* __restrict__ proto_r,
                 const float* __restrict__ proto_h, long long robot_stride,
                 float* __restrict__ table, unsigned char* __restrict__ model_out,
                 float* __restrict__ f_out, unsigned char* __restrict__ sufficient_out,
                 unsigned long long* __restrict__ sweep_ctr, int S, int L, int C, GpParams p) {
  extern __shared__ __align__(16) float smem[];
  float* s_M = smem;                   // C x C factor, (i, j) at j * C + i
  const int ldy = C + 1;
  float* s_Y = s_M + C * C;            // C x (C + 1) substitution, (a, t) at a * ldy + t
  float* s_h = s_Y + C * ldy;          // the slots' prototype heights
  float* s_r = s_h + C;                // ... ranges
  float* s_f = s_r + C;                // ... regressed heights
  float* s_d = s_f + C;                // the factor's diagonal
  float* s_key = s_d + C;              // the bins' sort keys
  int* s_slot = reinterpret_cast<int*>(s_key + L);   // each bin's slot (>= C: none)
  int* s_idx = s_slot + L;             // the model's slots, in slot order
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_idx + C);
  unsigned char* s_model = s_valid + C;

  const int s = blockIdx.x, b = blockIdx.y, t = threadIdx.x, nt = blockDim.x;
  const long long in0 = (long long)b * robot_stride + (long long)s * L;

  // the signal: the bins ranked as the stable argsort of their keys orders
  // them (invalid bins keyed +inf), the first C as slots
  for (int i = t; i < L; i += nt)
    s_key[i] = count[in0 + i] > p.min_bin_points ? proto_h[in0 + i] : INFINITY;
  __syncthreads();
  for (int i = t; i < L; i += nt) {
    const float k = s_key[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) {
      const float kj = s_key[j];
      rank += (kj < k) || (kj == k && j < i);
    }
    s_slot[i] = rank;
    if (rank < C) {
      s_h[rank] = proto_h[in0 + i];
      s_r[rank] = proto_r[in0 + i];
      s_valid[rank] = count[in0 + i] > p.min_bin_points;
    }
  }
  __syncthreads();

  // seeds: the first num_seed_points qualifying slots, at most as many as
  // the valid slots; thread t < C owns slot t
  const bool own = t < C;
  const bool valid = own && s_valid[t];
  const int nvalid = __syncthreads_count(valid);
  const int npt = min(nvalid, p.num_seed_points);
  bool model = false;
  if (own) {
    int rank = 0;
    for (int c = 0; c <= t; ++c)
      rank += s_valid[c] && s_r[c] < p.seed_max_range && fabsf(s_h[c]) < p.seed_max_height;
    model = valid && s_r[t] < p.seed_max_range && fabsf(s_h[t]) < p.seed_max_height &&
            rank <= npt;
    s_model[t] = model;
  }
  const bool sufficient = __syncthreads_count(model) >= 2;
  bool active = __syncthreads_or(valid && !model) && sufficient;

  // the sweeps, until the sector adopts nothing or nothing is left to adopt
  float f_own = 0.f;
  int sweeps = 0;
  while (active && sweeps < p.sweeps) {
    ++sweeps;
    if (own && model) {
      int pos = 0;
      for (int c = 0; c < t; ++c) pos += s_model[c];
      s_idx[pos] = t;
    }
    const int n = __syncthreads_count(own && model);
    // the model's system, lower triangle: k(r_i, r_j), k + noise on the
    // diagonal
    for (int e = t; e < n * n; e += nt) {
      const int j = e / n, i = e - j * n;
      if (i >= j) {
        const float a = se_kernel(s_r[s_idx[i]], s_r[s_idx[j]], p);
        s_M[j * C + i] = i == j ? __fadd_rn(a, p.noise) : a;
      }
    }
    __syncthreads();
    // Cholesky, right-looking, thread i updating row i
    for (int k = 0; k < n; ++k) {
      const float dkk = __fsqrt_rn(s_M[k * C + k]);
      if (t == k) s_d[k] = dkk;
      if (t > k && t < n) s_M[k * C + t] = __fdiv_rn(s_M[k * C + t], dkk);
      __syncthreads();
      if (t > k && t < n) {
        const float lik = s_M[k * C + t];
        for (int j = k + 1; j <= t; ++j)
          s_M[j * C + t] = __fmaf_rn(-lik, s_M[k * C + j], s_M[j * C + t]);
      }
      __syncthreads();
    }
    // forward substitution, thread t solving column t
    if (t < ldy) {
      const float rc = t > 0 ? s_r[t - 1] : 0.f;
      for (int a = 0; a < n; ++a) {
        const int ia = s_idx[a];
        float sum = t == 0 ? s_h[ia] : se_kernel(rc, s_r[ia], p);
        for (int q = 0; q < a; ++q) sum = __fmaf_rn(-s_M[q * C + a], s_Y[q * ldy + t], sum);
        s_Y[a * ldy + t] = __fdiv_rn(sum, s_d[a]);
      }
    }
    __syncthreads();
    // each slot's regression and inlier test
    bool inlier = false;
    if (own) {
      float f = 0.f, q = 0.f;
      for (int a = 0; a < n; ++a) {
        const float y = s_Y[a * ldy + t + 1];
        f = __fmaf_rn(y, s_Y[a * ldy], f);
        q = __fmaf_rn(y, y, q);
      }
      const float v = __fsub_rn(p.signal_var, q);
      const float met = __fdiv_rn(__fsub_rn(s_h[t], f),
                                  __fsqrt_rn(__fadd_rn(p.noise, __fmul_rn(v, v))));
      inlier = valid && !model && v < p.model_conf && fabsf(met) < p.data_conf;
      f_own = f;
      model = model || inlier;
      s_model[t] = model;
    }
    const int adopted = __syncthreads_or(inlier);
    active = adopted && __syncthreads_or(valid && !model);
  }

  const long long sec = (long long)b * S + s;
  if (own) {
    model_out[sec * C + t] = model;
    f_out[sec * C + t] = f_own;
    s_f[t] = f_own;
  }
  if (t == 0) {
    sufficient_out[sec] = sufficient;
    if (sweep_ctr != nullptr && sweeps > 0) atomicAdd(sweep_ctr, (unsigned long long)sweeps);
  }
  __syncthreads();

  // the bins' rows: in the signal, in the model, prototype height,
  // regressed height (signal bins), sector sufficient; robot b's row S * L
  // (points off the grid) is zeros
  float* rows = table + ((long long)b * ((long long)S * L + 1) + (long long)s * L) * 5;
  for (int e = t; e < 5 * L; e += nt) {
    const int i = e / 5, col = e - 5 * i;
    const int c = s_slot[i];
    const bool sig = c < C && s_valid[c];
    float v;
    if (col == 0) v = sig ? 1.f : 0.f;
    else if (col == 1) v = sig && s_model[c] ? 1.f : 0.f;
    else if (col == 2) v = proto_h[in0 + i];
    else if (col == 3) v = sig ? s_f[c] : 0.f;
    else v = sufficient ? 1.f : 0.f;
    rows[e] = v;
  }
  if (s == 0 && t < 5) table[((long long)b * ((long long)S * L + 1) + (long long)S * L) * 5 + t] = 0.f;
}

}  // namespace

// slam_ground_gp: count, proto_r, proto_h (B, S, L) f32, robot b's sector
// s at element b * robot_stride + s * L; out table (B, S * L + 1, 5) f32,
// model (B, S, C) bool bytes, f_s (B, S, C) f32, sufficient (B, S) bool
// bytes; sweep_ctr null or an int64 each block adds its sweeps to. C <= L
// and C <= 128 signal slots. smem is the dynamic shared memory a block
// holds: 4 (C^2 + C (C + 1) + 4C + L) + 4 (L + C) + 2C bytes
// (ops/ground.py `gp_shared_bytes`).
extern "C" int slam_ground_gp(const float* count, const float* proto_r, const float* proto_h,
                              long long robot_stride, float* table, unsigned char* model,
                              float* f_s, unsigned char* sufficient, unsigned long long* sweep_ctr,
                              int B, int S, int L, int C, int sweeps, int num_seed_points,
                              float min_bin_points, float seed_max_range, float seed_max_height,
                              float signal_var, float inv_two_l2, float noise, float model_conf,
                              float data_conf, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (C < 1 || C > kMaxSlots || C > L || B > 65535) return (int)cudaErrorInvalidValue;
  const int smem = 4 * (C * C + C * (C + 1) + 4 * C + L) + 4 * (L + C) + 2 * C;
  const int threads = (C + 1 + 31) / 32 * 32;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ground_gp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  GpParams p;
  p.min_bin_points = min_bin_points;
  p.seed_max_range = seed_max_range;
  p.seed_max_height = seed_max_height;
  p.signal_var = signal_var;
  p.inv_two_l2 = inv_two_l2;
  p.noise = noise;
  p.model_conf = model_conf;
  p.data_conf = data_conf;
  p.num_seed_points = num_seed_points;
  p.sweeps = sweeps;
  ground_gp_kernel<<<dim3(S, B), threads, smem, (cudaStream_t)stream>>>(
      count, proto_r, proto_h, robot_stride, table, model, f_s, sufficient, sweep_ctr, S, L, C,
      p);
  return (int)cudaGetLastError();
}
