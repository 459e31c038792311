// Whole-solve DL-CCVM kernel for Hopper (sm_90a), plain and Adam variants.
//
// Replaces the Pallas TPU kernels `_dl_kernel` and `_dl_adam_kernel`
// (ccvm_tpu/ops/pallas_kernels.py:843 and :977).  One launch integrates every
// Euler-Maruyama step of a batch of independent trajectories:
//
//   rate  = (i+1)/T (or 1);  nr_i = (nr-1) e^{-3(i+1)/T} + 1
//   S_d   = sqrt(pump-1) if pump > 1 else S            (drift only)
//   x     = z * (u-l) / S_d + (u+l)     for z in {c, s}
//   fb    = 0.25 * (x @ Q) * (u-l) / S_d;  g3 = V * (u-l) / (2 S_d)
//   plain: drift_c = -fs(0.5+rate)(fb_c+g3) + (-1 + pump*rate - c^2 - s^2) c
//          drift_s = -fs(0.5+rate)(fb_s+g3) + (-1 - pump*rate - c^2 - s^2) s
//   Adam:  grads = -fb - g3 filtered by Adam (bias correction beta^(i+1));
//          drift_c = (-1 + pump*rate - c^2 - s^2) c + grads_c, likewise s;
//          feedback_scale is unused
//   c += dt*drift_c + 2g sqrt(c^2+s^2+0.5) * sqrt(dt)*nr_i * w_c  (s: /nr_i)
//   clip c, s to +-1e3 every step; after the loop clamp c (only) to +-S.
//
// What bounds it on this card: arithmetic.  The two matvecs are
// 4*B*N^2*T fp32 flops, plus ~40*B*N*T elementwise flops and one Philox
// call per 4 elements per step; at B=65536, N=70, T=15000 that is ~1.9e13 +
// 2.8e12 flop.  Q and the state never leave the chip, so the bytes (Q and V
// in, c and s out) are negligible.
//
// What this simple design does about it:
//   * one thread block owns R trajectories for ALL iterations, in one launch;
//     blocks are independent (trajectories do not interact);
//   * Q (zero-padded to NP x NP, NP = N rounded up to 4) lives in shared
//     memory for the whole solve; the block's x_c and x_s rows are rebuilt in
//     shared memory each step, since every output column needs the whole row;
//   * each thread owns a 4-row x 4-column tile of c and s (and of the four
//     Adam moments) in registers and computes both matvecs for it with IEEE
//     fp32 FMAs on the CUDA cores (no TF32, no mma), reading float4s of x and
//     Q: 32 FMAs per 3 shared loads;
//   * noise is a stateless Philox4x32-10: key = seed + instance, counter =
//     (step, trajectory row, column/4, stream), word = column % 4.  Draws do
//     not depend on R or on the grid, and ops/philox.py reproduces them;
//   * the grid is (ceil(batch/R), instances): blockIdx.y is the instance.
// Tensor cores (3xTF32 wgmma), TMA and persistent blocks are later work.
//
// Philox, the Wiener transforms, the clip and the Adam update are shared with
// mf_solve.cu through ccvm_common.cuh.  Specialisations (the template
// parameters) are chosen at build time with -D flags by
// ccvm_tpu_torch/ops/build.py; each build exports ccvm_dl_solve.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"

namespace {

using namespace ccvm;

constexpr float kSafetyBound = 1.0e3f;  // _DL_SAFETY_BOUND

struct DLScalars {
  float pump, S, dt, noise_ratio, fs, g, lo, hi, T;
  float alpha, beta1, one_minus_beta1, beta2, one_minus_beta2;
  float noise_scale;
};
static_assert(sizeof(DLScalars) == 15 * sizeof(float), "DLScalars layout");

template <bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool PUMP_RATE_FLAG,
          bool PUMP_GT_ONE, bool NOISE, int RNG>
__global__ void __launch_bounds__(kMaxThreads)
dl_solve_kernel(const float* __restrict__ q, const float* __restrict__ v,
                float* __restrict__ c_out, float* __restrict__ s_out,
                int batch, int n, int iterations, unsigned long long seed,
                DLScalars p) {
  extern __shared__ __align__(16) float smem[];
  const int np = (n + TC - 1) / TC * TC;
  const int ks = np + 4;  // x row stride: spreads two row groups over banks
  const int groups = np / TC;
  const int rgroups = blockDim.x / groups;
  const int R = rgroups * TR;
  float* qs = smem;             // (np, np), zero-padded
  float* xc = qs + np * np;     // (R, ks)
  float* xs = xc + R * ks;      // (R, ks)

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

  const float S_d = PUMP_GT_ONE ? sqrtf(p.pump - 1.0f) : p.S;
  const float sqrt_dt = sqrtf(p.dt);
  const float span = p.hi - p.lo;
  const float mid = p.hi + p.lo;
  float g3[TC];
#pragma unroll
  for (int jj = 0; jj < TC; ++jj) {
    const int j = col0 + jj;
    g3[jj] = j < n ? v[(size_t)inst * n + j] * span / (2.0f * S_d) : 0.0f;
  }
  const uint2 key = seed_key(seed, inst);

  float c[TR][TC], s[TR][TC];
  float mc[TR][TC], vc[TR][TC], ms[TR][TC], vs[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      c[r][jj] = s[r][jj] = 0.0f;
      mc[r][jj] = vc[r][jj] = ms[r][jj] = vs[r][jj] = 0.0f;
    }

  for (int i = 0; i < iterations; ++i) {
    // x rows of this step (padding columns meet zero rows of Q).
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float4 a, b;
      a.x = c[r][0] * span / S_d + mid;
      a.y = c[r][1] * span / S_d + mid;
      a.z = c[r][2] * span / S_d + mid;
      a.w = c[r][3] * span / S_d + mid;
      b.x = s[r][0] * span / S_d + mid;
      b.y = s[r][1] * span / S_d + mid;
      b.z = s[r][2] * span / S_d + mid;
      b.w = s[r][3] * span / S_d + mid;
      *reinterpret_cast<float4*>(xc + (lrow0 + r) * ks + col0) = a;
      *reinterpret_cast<float4*>(xs + (lrow0 + r) * ks + col0) = b;
    }
    __syncthreads();

    float qc[TR][TC], qsum[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) qc[r][jj] = qsum[r][jj] = 0.0f;
    for (int k = 0; k < np; k += 4) {
      float4 qv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        qv[kk] = *reinterpret_cast<const float4*>(qs + (k + kk) * np + col0);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(xc + (lrow0 + r) * ks + k);
        const float4 b = *reinterpret_cast<const float4*>(xs + (lrow0 + r) * ks + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float ak = comp(a, kk), bk = comp(b, kk);
#pragma unroll
          for (int jj = 0; jj < TC; ++jj) {
            qc[r][jj] = fmaf(ak, comp(qv[kk], jj), qc[r][jj]);
            qsum[r][jj] = fmaf(bk, comp(qv[kk], jj), qsum[r][jj]);
          }
        }
      }
    }
    __syncthreads();  // every read of x is done before the next step writes

    const float fi1 = (float)i + 1.0f;
    const float rate = PUMP_RATE_FLAG ? fi1 / p.T : 1.0f;
    const float nr_i = (p.noise_ratio - 1.0f) * expf(-fi1 / p.T * 3.0f) + 1.0f;
    float b1i = 1.0f, b2i = 1.0f;
    if (ADAM) {
      b1i = 1.0f - powf(p.beta1, fi1);
      if (!BETA2_ONE) b2i = 1.0f - powf(p.beta2, fi1);
    }
    const float fs_dyn = p.fs * (0.5f + rate);
    const float pr = p.pump * rate;

#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float z1[TC], z2[TC];
      if (NOISE) {
        constexpr int NS = streams_of(RNG);
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
          normal_pair<RNG>(w, z1[jj], z2[jj]);
          z1[jj] *= p.noise_scale;
          z2[jj] *= p.noise_scale;
        }
      }
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        const float cv = c[r][jj], sv = s[r][jj];
        const float c_pow = cv * cv;
        const float s_pow = sv * sv;
        const float fb_c = 0.25f * qc[r][jj] * span / S_d;
        const float fb_s = 0.25f * qsum[r][jj] * span / S_d;
        float c_drift, s_drift;
        if (ADAM) {
          const float gc = adam<BETA2_ONE, ADD_ASSIGN>(
              -fb_c - g3[jj], mc[r][jj], vc[r][jj], b1i, b2i, p);
          const float gs = adam<BETA2_ONE, ADD_ASSIGN>(
              -fb_s - g3[jj], ms[r][jj], vs[r][jj], b1i, b2i, p);
          c_drift = ((-1.0f + pr - c_pow - s_pow) * cv) + gc;
          s_drift = ((-1.0f - pr - c_pow - s_pow) * sv) + gs;
        } else {
          c_drift = -fs_dyn * (fb_c + g3[jj]) + (-1.0f + pr - c_pow - s_pow) * cv;
          s_drift = -fs_dyn * (fb_s + g3[jj]) + (-1.0f - pr - c_pow - s_pow) * sv;
        }
        float cn = cv + p.dt * c_drift;
        float sn = sv + p.dt * s_drift;
        if (NOISE) {
          const float diff = 2.0f * p.g * sqrtf(c_pow + s_pow + 0.5f);
          cn = cn + diff * (z1[jj] * sqrt_dt * nr_i);
          sn = sn + diff * (z2[jj] * sqrt_dt / nr_i);
        }
        c[r][jj] = clip(cn, kSafetyBound);
        s[r][jj] = clip(sn, kSafetyBound);
      }
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
        c_out[base + j] = clip(c[r][jj], p.S);
        s_out[base + j] = s[r][jj];
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
#ifndef CCVM_PUMP_GT_ONE
#define CCVM_PUMP_GT_ONE 1
#endif
#ifndef CCVM_NOISE
#define CCVM_NOISE 1
#endif
#ifndef CCVM_RNG
#define CCVM_RNG 1
#endif

extern "C" {

// q (I, n, n), v (I, n), c_out / s_out (I, batch, n): float32, contiguous,
// on the device.  scalars: 15 host floats in DLScalars order.  Launches on
// `stream`, does not synchronise, and returns the cudaError_t of the launch.
int ccvm_dl_solve(const float* q, const float* v, float* c_out, float* s_out,
                  int num_instances, int batch, int n, int iterations,
                  unsigned long long seed, const float* scalars,
                  int rows_per_block, void* stream) {
  DLScalars p;
  memcpy(&p, scalars, sizeof(DLScalars));
  int threads;
  long long smem;
  if (ccvm::launch_shape(n, rows_per_block, 2, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = dl_solve_kernel<CCVM_ADAM != 0, CCVM_BETA2_ONE != 0,
                                CCVM_ADD_ASSIGN != 0, CCVM_PUMP_RATE_FLAG != 0,
                                CCVM_PUMP_GT_ONE != 0, CCVM_NOISE != 0,
                                CCVM_RNG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, num_instances);
  kernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, c_out, s_out, batch, n, iterations, seed, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
