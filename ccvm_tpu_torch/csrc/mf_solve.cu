// Whole-solve MF-CCVM kernel for Hopper (sm_90a), plain and Adam variants.
//
// Replaces the Pallas TPU kernels `_mf_kernel` and `_mf_adam_kernel`
// (ccvm_tpu/ops/pallas_kernels.py:1085 and :1224).  One launch integrates
// every Euler-Maruyama step of a batch of independent trajectories:
//
//   j_i   = j e^{-3(i+1)/T};  rate = (i+1)/T (or 1)
//   w     = one normal draw * noise_scale;  w_inc = w / sqrt(dt)
//   mt    = mu + sqrt(1/(4 j_i)) w_inc;     mt_c = clip(mt, +-S)
//   pump  = pump*rate + 1 + j_i;            k1 = -(1 + j_i) + pump
//   x     = mt_c (u-l)/S + (u+l);           fb = -0.25 (x @ Q)(u-l)/S - V(u-l)/(2S)
//   plain: drift_mu = (k1 - g^2 mu^2) mu + fs fb
//          mu += dt (drift_mu + sqrt(j_i)(sigma - 1/2) w_inc)
//   Adam:  grads = fs fb filtered by Adam (bias correction beta^(i+1));
//          mu += dt (grads + (k1 - g^2 mu^2) mu + sqrt(j_i)(sigma - 1/2) w_inc)
//   sigma += dt (2(k1 - 3g^2 mu^2) sigma - 2 j_i (sigma - 1/2)^2 + (1 + j_i)
//                + 2 g^2 mu^2)
//   clip mu to +-1e5 every step (_MF_SAFETY_BOUND).  The readout mt is the
//   LAST step's pre-update value, clamped to +-S; the same draw feeds mt and
//   the diffusion of mu.
//
// What bounds it on this card: arithmetic.  The one matvec is 2*B*N^2*T fp32
// flops, plus ~40*B*N*T elementwise flops (three IEEE divisions among them)
// and one Philox call per 4 elements per step; at B=65536, N=70, T=15000
// that is ~9.6e12 + 2.8e12 flop.  Q and the state never leave the chip, so
// the bytes (Q and V in, mu, mt and sigma out) are negligible.
//
// What this simple design does about it, as dl_solve.cu does:
//   * one thread block owns R trajectories for ALL iterations, in one launch;
//   * Q (zero-padded to NP x NP) lives in shared memory for the whole solve;
//     the block's x rows (one array: MF has one quadrature) are rebuilt in
//     shared memory each step;
//   * each thread owns a 4-row x 4-column tile of mu and sigma (and of the
//     two Adam moments) in registers, and keeps its tile's w_inc across the
//     matvec, so one draw serves mt and the diffusion; IEEE fp32 FMAs on the
//     CUDA cores (no TF32, no mma);
//   * mt is not carried through the loop: the last step writes it once;
//   * the per-step scalars (j_i, sqrt(1/(4 j_i)), sqrt(j_i), the pump) are
//     computed once a step, outside the element loop;
//   * __launch_bounds__(256, 2) keeps two blocks on each SM (128 registers;
//     the Adam variant spills a few bytes);
//   * noise: the Philox4x32-10 of ccvm_common.cuh, key = seed + instance,
//     counter = (step, row, column/4, stream); the grid is
//     (ceil(batch/R), instances).
// Specialisations are chosen at build time with -D flags by
// ccvm_tpu_torch/ops/build.py; each build exports ccvm_mf_solve.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"

namespace {

using namespace ccvm;

constexpr float kSafetyBound = 1.0e5f;  // _MF_SAFETY_BOUND
// Two blocks per SM: ptxas caps the kernel at 128 registers.  Without the
// cap it takes 148-176, and one 252-thread block per SM leaves the FMA
// pipes idle between the matvec's shared-memory loads.
constexpr int kMinBlocks = 2;

struct MFScalars {
  float pump, S, dt, j, fs, g, lo, hi, T;
  float alpha, beta1, one_minus_beta1, beta2, one_minus_beta2;
  float noise_scale;
};
static_assert(sizeof(MFScalars) == 15 * sizeof(float), "MFScalars layout");

template <bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool PUMP_RATE_FLAG,
          bool NOISE, int RNG>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
mf_solve_kernel(const float* __restrict__ q, const float* __restrict__ v,
                float* __restrict__ mu_out, float* __restrict__ mt_out,
                float* __restrict__ sigma_out, int batch, int n,
                int iterations, unsigned long long seed, MFScalars p) {
  extern __shared__ __align__(16) float smem[];
  const int np = (n + TC - 1) / TC * TC;
  const int ks = np + 4;  // x row stride: spreads two row groups over banks
  const int groups = np / TC;
  const int rgroups = blockDim.x / groups;
  const int R = rgroups * TR;
  float* qs = smem;          // (np, np), zero-padded
  float* xs = qs + np * np;  // (R, ks)

  const int inst = blockIdx.y;
  const int tid = threadIdx.x;
  const int cg = tid % groups;
  const int rg = tid / groups;
  const int col0 = cg * TC;
  const int lrow0 = rg * TR;
  const int grow0 = blockIdx.x * R + lrow0;

  const float* qi = q + (size_t)inst * n * n;
  for (int e = tid; e < np * np; e += blockDim.x) {
    const int k = e / np, j = e % np;
    qs[e] = (k < n && j < n) ? qi[k * n + j] : 0.0f;
  }

  const float sqrt_dt = sqrtf(p.dt);
  const float span = p.hi - p.lo;
  const float mid = p.hi + p.lo;
  const float g_sq = p.g * p.g;
  const float g_sq3 = 3.0f * g_sq;
  const float g_sq2 = 2.0f * g_sq;
  float fb_v[TC];  // -V (u-l) / (2S)
#pragma unroll
  for (int jj = 0; jj < TC; ++jj) {
    const int j = col0 + jj;
    fb_v[jj] = j < n ? -v[(size_t)inst * n + j] * span / (2.0f * p.S) : 0.0f;
  }
  const uint2 key = seed_key(seed, inst);

  float mu[TR][TC], sigma[TR][TC], m1[TR][TC], m2[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      mu[r][jj] = m1[r][jj] = m2[r][jj] = 0.0f;
      sigma[r][jj] = 0.5f;
    }

  for (int i = 0; i < iterations; ++i) {
    const float fi1 = (float)i + 1.0f;
    const float j_i = p.j * expf(-fi1 / p.T * 3.0f);
    const float meas = sqrtf(1.0f / (4.0f * j_i));
    const bool last = i == iterations - 1;

    // The step's draw, mt and x rows (padding columns meet zero rows of Q).
    float w_inc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (NOISE) {
        constexpr int NS = streams_one_of(RNG);
        uint4 wv[NS];
#pragma unroll
        for (int st = 0; st < NS; ++st)
          wv[st] = philox4x32_10(
              make_uint4((unsigned)i, (unsigned)(grow0 + r), (unsigned)cg,
                         (unsigned)st),
              key);
#pragma unroll
        for (int jj = 0; jj < TC; ++jj) {
          unsigned w[NS];
#pragma unroll
          for (int st = 0; st < NS; ++st) w[st] = word_of(wv[st], jj);
          w_inc[r][jj] = normal_one<RNG>(w) * p.noise_scale / sqrt_dt;
        }
      }
      float x[TC];
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        const float mt = NOISE ? mu[r][jj] + meas * w_inc[r][jj] : mu[r][jj];
        if (last) {
          const int row = grow0 + r, j = col0 + jj;
          if (row < batch && j < n)
            mt_out[((size_t)inst * batch + row) * n + j] = clip(mt, p.S);
        }
        x[jj] = clip(mt, p.S) * span / p.S + mid;
      }
      *reinterpret_cast<float4*>(xs + (lrow0 + r) * ks + col0) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    float qx[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) qx[r][jj] = 0.0f;
    for (int k = 0; k < np; k += 4) {
      float4 qv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        qv[kk] = *reinterpret_cast<const float4*>(qs + (k + kk) * np + col0);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(xs + (lrow0 + r) * ks + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float ak = comp(a, kk);
#pragma unroll
          for (int jj = 0; jj < TC; ++jj)
            qx[r][jj] = fmaf(ak, comp(qv[kk], jj), qx[r][jj]);
        }
      }
    }
    __syncthreads();  // every read of x is done before the next step writes

    const float rate = PUMP_RATE_FLAG ? fi1 / p.T : 1.0f;
    const float pump_inst = p.pump * rate + 1.0f + j_i;
    const float k1 = -(1.0f + j_i) + pump_inst;
    const float one_j = 1.0f + j_i;
    const float two_j = -2.0f * j_i;
    const float sqrt_j = sqrtf(j_i);
    float b1i = 1.0f, b2i = 1.0f;
    if (ADAM) {
      b1i = 1.0f - powf(p.beta1, fi1);
      if (!BETA2_ONE) b2i = 1.0f - powf(p.beta2, fi1);
    }

#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        const float m = mu[r][jj], sg = sigma[r][jj];
        const float mu_pow = m * m;
        const float fb = -0.25f * qx[r][jj] * span / p.S + fb_v[jj];
        const float sd = sg - 0.5f;
        const float drift_sigma = 2.0f * (k1 - g_sq3 * mu_pow) * sg +
                                  two_j * (sd * sd) + (one_j + g_sq2 * mu_pow);
        float mu_new;
        if (ADAM) {
          const float eff = adam<BETA2_ONE, ADD_ASSIGN>(
              p.fs * fb, m1[r][jj], m2[r][jj], b1i, b2i, p);
          float mu_drift = (k1 - g_sq * mu_pow) * m;
          if (NOISE) mu_drift = mu_drift + sqrt_j * sd * w_inc[r][jj];
          mu_new = m + p.dt * (eff + mu_drift);
        } else {
          float drift = (k1 - g_sq * mu_pow) * m + p.fs * fb;
          if (NOISE) drift = drift + sqrt_j * sd * w_inc[r][jj];
          mu_new = m + p.dt * drift;
        }
        mu[r][jj] = clip(mu_new, kSafetyBound);
        sigma[r][jj] = sg + p.dt * drift_sigma;
      }
  }

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = grow0 + r;
    if (row >= batch) continue;
    const size_t base = ((size_t)inst * batch + row) * n;
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      const int j = col0 + jj;
      if (j < n) {
        mu_out[base + j] = mu[r][jj];
        sigma_out[base + j] = sigma[r][jj];
      }
    }
  }
}

}  // namespace

#ifndef CCVM_ADAM
#define CCVM_ADAM 0
#endif
#ifndef CCVM_BETA2_ONE
#define CCVM_BETA2_ONE 0
#endif
#ifndef CCVM_ADD_ASSIGN
#define CCVM_ADD_ASSIGN 0
#endif
#ifndef CCVM_PUMP_RATE_FLAG
#define CCVM_PUMP_RATE_FLAG 1
#endif
#ifndef CCVM_NOISE
#define CCVM_NOISE 1
#endif
#ifndef CCVM_RNG
#define CCVM_RNG 0
#endif

extern "C" {

// q (I, n, n), v (I, n), mu_out / mt_out / sigma_out (I, batch, n): float32,
// contiguous, on the device; mt_out is left as it is when iterations is 0.
// scalars: 15 host floats in MFScalars order.  Launches on `stream`, does
// not synchronise, and returns the cudaError_t of the launch.
int ccvm_mf_solve(const float* q, const float* v, float* mu_out,
                  float* mt_out, float* sigma_out, int num_instances,
                  int batch, int n, int iterations, unsigned long long seed,
                  const float* scalars, int rows_per_block, void* stream) {
  MFScalars p;
  memcpy(&p, scalars, sizeof(MFScalars));
  int threads;
  long long smem;
  if (ccvm::launch_shape(n, rows_per_block, 1, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = mf_solve_kernel<CCVM_ADAM != 0, CCVM_BETA2_ONE != 0,
                                CCVM_ADD_ASSIGN != 0, CCVM_PUMP_RATE_FLAG != 0,
                                CCVM_NOISE != 0, CCVM_RNG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, num_instances);
  kernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, mu_out, mt_out, sigma_out, batch, n, iterations, seed, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
