// Whole-solve kernels of the DL race harness for Hopper (sm_90a): the two
// variants of the DL-CCVM step that are raced against the production kernel
// (dl_solve.cu).
//
// Replaces the Pallas TPU kernels `_dl_kernel_v2` and `_dl_kernel_v3`
// (tools/kernel_experiments.py:91 and :201).  Both integrate the DL-CCVM SDE
// of dl_solve.cu with no per-step safety clip, the pump rate always (i+1)/T
// and the drift saturation always S_d = sqrt(pump-1).  With span = u-l,
// mid = u+l, g3 = V*span/(2 S_d), nr_i = (nr-1) e^{-3(i+1)/T} + 1 and
// diff = 2g sqrt(c^2+s^2+0.5), a step is, for z in {c, s}:
//
//   v2: fb_z = 0.25 * ((z*(span/S_d) + mid) @ Q) * (span/S_d)
//       drift_c = -fs(0.5+rate)(fb_c + g3) + (-1 + pump*rate - c^2 - s^2) c
//       c += dt*drift_c + diff * (z1 * (sqrt(dt)*nr_i))      (s: -pump, /nr_i)
//   v3: the change of variables folded into Q once, before the loop:
//       fb_z = (z @ Q) * qs + fb0,  qs = 0.25 span^2/S_d^2,
//       fb0 = 0.25 span/S_d * mid * colsum(Q) + g3
//       drift_c = -fs(0.5+rate)(fb_c) + (-1 + pump*rate - (c^2+s^2)) c
//       c += dt*drift_c + (diff * (sqrt(dt)*nr_i)) * z1
//   after the loop c (only) is clamped to +-S; a NaN stays NaN, as in
//   jnp.clip, so a diverged trajectory shows in both outputs.
//
// Without the clip an explicit step that overshoots grows to Inf: past
// step T the pump rate keeps growing, so the harness's long races may end
// non-finite.  They only time the kernels.
//
// Knobs, as template parameters chosen with -D flags by ops/build.py
// DLVariantSpec (one library each, exporting ccvm_dl_variant):
//   V3      the v3 step above, else v2;
//   FUSE    both matvecs in one pass over the shared-memory Q, each float4 of
//           Q feeding c and s (dl_solve.cu's loop); else two passes, Q read
//           twice.  On the TPU the knob stacked c and s rows into one MXU call;
//   UNROLL  steps per outer iteration, fully unrolled; a tail loop covers
//           iterations % UNROLL (v2's wrapper requires 0, as the TPU kernel
//           asserts);
//   NOISE   0 elides the generator (the noise-off parity mode);
//   RNG     index into ops/philox.py HARNESS_RNG_NAMES: 0 popcount1 (the
//           popcount32 pair, 2 Philox streams per element), 1 popcount2
//           (4 streams), 2 popcount3(prod) (the popcount pair, 6 streams).
//
// What bounds it on this card: arithmetic, as dl_solve.cu (two matvecs,
// 4*B*N^2 flop a step, plus ~40*B*N elementwise flop and the Philox calls).
// The design is dl_solve.cu's: one block owns R trajectories for the whole
// solve, Q zero-padded to NP x NP in shared memory, a 4x4 register tile of
// c and s per thread, IEEE fp32 FMAs on the CUDA cores, stateless Philox4x32-10
// keyed by seed + instance and counted by (step, row, column/4, stream), so
// a stacked instance i draws what a solve with seed + i draws.  v3 writes c
// and s themselves to shared memory (no per-step x rebuild) and keeps
// colsum(Q) and fb0 in registers.  Padding columns draw no noise and are
// never written, so they stay 0.  The TPU kernels seed the hardware
// generator per grid program instead, which cannot be replayed.
//
// Every specialisation is held to 128 registers, two 252-thread blocks per
// SM at N=70 as the production DL kernel runs, so the race compares the
// knobs at one occupancy; left free, ptxas gives most noise-on
// specialisations more registers and one block per SM, slower at the main
// shape.  Some specialisations spill a few bytes; chip_smoke.py prints
// ptxas's report for each.  Unlike dl_solve.cu, the scalar quotients
// (span/S_d, sqrt(dt)/nr_i) are taken once, as the TPU variants write them,
// not per element.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"

namespace {

using namespace ccvm;

constexpr int kMinBlocks = 2;  // blocks per SM: at most 128 registers

struct VariantScalars {
  float pump, S, dt, noise_ratio, fs, g, lo, hi, T;
  float noise_scale;
};
static_assert(sizeof(VariantScalars) == 10 * sizeof(float), "VariantScalars layout");

// Philox streams per element of each harness transform.
__host__ __device__ constexpr int harness_streams(int rng) {
  return rng == 0 ? 2 : rng == 1 ? 4 : 6;
}

// The harness's pair transforms on Philox words (w[k]: stream k).
template <int RNG>
__device__ __forceinline__ void harness_pair(const unsigned* w, float& z1,
                                             float& z2) {
  if constexpr (RNG == 1) {
    // popcount2: Binomial(64, 1/2) centred, variance 16, no smoothing.
    z1 = (float)(__popc(w[0]) + __popc(w[1]) - 32) * 0.25f;
    z2 = (float)(__popc(w[2]) + __popc(w[3]) - 32) * 0.25f;
  } else {
    normal_pair<RNG == 0 ? kPopcount32 : kPopcount>(w, z1, z2);
  }
}

// The clamp of jnp.clip: a NaN passes through.
__device__ __forceinline__ float clamp_keep_nan(float x, float b) {
  return x < -b ? -b : (x > b ? b : x);
}

// acc_a (and, with NX == 2, acc_b) += the thread's tile of x_a @ Q (x_b @ Q),
// in k order; with NX == 2 each float4 of Q read feeds both.
template <int NX>
__device__ __forceinline__ void tile_matvec(const float* __restrict__ q,
                                            const float* xa, const float* xb,
                                            float (&acc_a)[TR][TC],
                                            float (&acc_b)[TR][TC], int np,
                                            int ks, int lrow0, int col0) {
  for (int k = 0; k < np; k += 4) {
    float4 qv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      qv[kk] = *reinterpret_cast<const float4*>(q + (k + kk) * np + col0);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(xa + (lrow0 + r) * ks + k);
      float4 b = a;
      if constexpr (NX == 2) b = *reinterpret_cast<const float4*>(xb + (lrow0 + r) * ks + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float ak = comp(a, kk);
#pragma unroll
        for (int jj = 0; jj < TC; ++jj)
          acc_a[r][jj] = fmaf(ak, comp(qv[kk], jj), acc_a[r][jj]);
        if constexpr (NX == 2) {
          const float bk = comp(b, kk);
#pragma unroll
          for (int jj = 0; jj < TC; ++jj)
            acc_b[r][jj] = fmaf(bk, comp(qv[kk], jj), acc_b[r][jj]);
        }
      }
    }
  }
}

template <bool V3, bool FUSE, int UNROLL, bool NOISE, int RNG>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
dl_variant_kernel(const float* __restrict__ q, const float* __restrict__ v,
                  float* __restrict__ c_out, float* __restrict__ s_out,
                  int batch, int n, int iterations, unsigned long long seed,
                  VariantScalars p) {
  extern __shared__ __align__(16) float smem[];
  const int np = (n + TC - 1) / TC * TC;
  const int ks = np + 4;  // x row stride: spreads two row groups over banks
  const int groups = np / TC;
  const int rgroups = blockDim.x / groups;
  const int R = rgroups * TR;
  float* qs = smem;          // (np, np), zero-padded
  float* xc = qs + np * np;  // (R, ks): v2 the x of c, v3 c itself
  float* xs = xc + R * ks;   // (R, ks): likewise for s

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
  __syncthreads();  // v3 sums Q's columns before the loop

  const float S_d = sqrtf(p.pump - 1.0f);
  const float sqrt_dt = sqrtf(p.dt);
  const float span = p.hi - p.lo;
  const float mid = p.hi + p.lo;
  const float sc = span / S_d;
  const float alpha = 0.25f * span / S_d;
  const float qscale = alpha * sc;  // v3's qs
  // The constant feedback offset of each column: v2 g3, v3 fb0.
  float off[TC];
#pragma unroll
  for (int jj = 0; jj < TC; ++jj) {
    const int j = col0 + jj;
    const float g3 = j < n ? v[(size_t)inst * n + j] * span / (2.0f * S_d) : 0.0f;
    if (V3) {
      float colsum = 0.0f;
      for (int k = 0; k < np; ++k) colsum += qs[k * np + j];
      off[jj] = alpha * mid * colsum + g3;
    } else {
      off[jj] = g3;
    }
  }
  const uint2 key = seed_key(seed, inst);

  float c[TR][TC], s[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) c[r][jj] = s[r][jj] = 0.0f;

  auto step = [&](int i) {
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float4 a, b;
      if (V3) {
        a = make_float4(c[r][0], c[r][1], c[r][2], c[r][3]);
        b = make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      } else {
        a = make_float4(c[r][0] * sc + mid, c[r][1] * sc + mid,
                        c[r][2] * sc + mid, c[r][3] * sc + mid);
        b = make_float4(s[r][0] * sc + mid, s[r][1] * sc + mid,
                        s[r][2] * sc + mid, s[r][3] * sc + mid);
      }
      *reinterpret_cast<float4*>(xc + (lrow0 + r) * ks + col0) = a;
      *reinterpret_cast<float4*>(xs + (lrow0 + r) * ks + col0) = b;
    }
    __syncthreads();

    float qc[TR][TC], qsum[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) qc[r][jj] = qsum[r][jj] = 0.0f;
    if (FUSE) {
      tile_matvec<2>(qs, xc, xs, qc, qsum, np, ks, lrow0, col0);
    } else {
      tile_matvec<1>(qs, xc, nullptr, qc, qc, np, ks, lrow0, col0);
      tile_matvec<1>(qs, xs, nullptr, qsum, qsum, np, ks, lrow0, col0);
    }
    __syncthreads();  // every read of x is done before the next step writes

    const float fi1 = (float)i + 1.0f;
    const float rate = fi1 / p.T;
    const float nr_i = (p.noise_ratio - 1.0f) * expf(-fi1 / p.T * 3.0f) + 1.0f;
    const float fs_dyn = p.fs * (0.5f + rate);
    const float pr = p.pump * rate;

#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float z1[TC], z2[TC];
      if (NOISE) {
        constexpr int NS = harness_streams(RNG);
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
          harness_pair<RNG>(w, z1[jj], z2[jj]);
          const bool real = col0 + jj < n;
          z1[jj] = real ? z1[jj] * p.noise_scale : 0.0f;
          z2[jj] = real ? z2[jj] * p.noise_scale : 0.0f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        const float cv = c[r][jj], sv = s[r][jj];
        const float c_pow = cv * cv;
        const float s_pow = sv * sv;
        float cn, sn;
        if (V3) {
          const float fb_c = qc[r][jj] * qscale;
          const float fb_s = qsum[r][jj] * qscale;
          const float sum_pow = c_pow + s_pow;
          const float c_drift = -fs_dyn * (fb_c + off[jj]) + (-1.0f + pr - sum_pow) * cv;
          const float s_drift = -fs_dyn * (fb_s + off[jj]) + (-1.0f - pr - sum_pow) * sv;
          cn = cv + p.dt * c_drift;
          sn = sv + p.dt * s_drift;
          if (NOISE) {
            const float diff = 2.0f * p.g * sqrtf(sum_pow + 0.5f);
            cn = cn + (diff * (sqrt_dt * nr_i)) * z1[jj];
            sn = sn + (diff * (sqrt_dt / nr_i)) * z2[jj];
          }
        } else {
          const float fb_c = 0.25f * qc[r][jj] * sc;
          const float fb_s = 0.25f * qsum[r][jj] * sc;
          const float c_drift = -fs_dyn * (fb_c + off[jj]) + (-1.0f + pr - c_pow - s_pow) * cv;
          const float s_drift = -fs_dyn * (fb_s + off[jj]) + (-1.0f - pr - c_pow - s_pow) * sv;
          cn = cv + p.dt * c_drift;
          sn = sv + p.dt * s_drift;
          if (NOISE) {
            const float diff = 2.0f * p.g * sqrtf(c_pow + s_pow + 0.5f);
            cn = cn + diff * (z1[jj] * (sqrt_dt * nr_i));
            sn = sn + diff * (z2[jj] * (sqrt_dt / nr_i));
          }
        }
        c[r][jj] = cn;
        s[r][jj] = sn;
      }
    }
  };

  const int main_iters = iterations / UNROLL * UNROLL;
#pragma unroll 1
  for (int i0 = 0; i0 < main_iters; i0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) step(i0 + u);
  }
#pragma unroll 1
  for (int i = main_iters; i < iterations; ++i) step(i);

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = grow0 + r;
    if (row >= batch) continue;
    const size_t base = ((size_t)inst * batch + row) * n;
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      const int j = col0 + jj;
      if (j < n) {
        c_out[base + j] = clamp_keep_nan(c[r][jj], p.S);
        s_out[base + j] = s[r][jj];
      }
    }
  }
}

}  // namespace

#ifndef CCVM_V3
#define CCVM_V3 0
#endif
#ifndef CCVM_FUSE
#define CCVM_FUSE 0
#endif
#ifndef CCVM_UNROLL
#define CCVM_UNROLL 8
#endif
#ifndef CCVM_NOISE
#define CCVM_NOISE 1
#endif
#ifndef CCVM_RNG
#define CCVM_RNG 0
#endif

extern "C" {

// q (I, n, n), v (I, n), c_out / s_out (I, batch, n): float32, contiguous,
// on the device.  scalars: 10 host floats in VariantScalars order.  Launches
// on `stream`, does not synchronise, and returns the cudaError_t of the
// launch.
int ccvm_dl_variant(const float* q, const float* v, float* c_out, float* s_out,
                    int num_instances, int batch, int n, int iterations,
                    unsigned long long seed, const float* scalars,
                    int rows_per_block, void* stream) {
  VariantScalars p;
  memcpy(&p, scalars, sizeof(VariantScalars));
  int threads;
  long long smem;
  if (ccvm::launch_shape(n, rows_per_block, 2, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = dl_variant_kernel<CCVM_V3 != 0, CCVM_FUSE != 0, CCVM_UNROLL,
                                  CCVM_NOISE != 0, CCVM_RNG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, num_instances);
  kernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, c_out, s_out, batch, n, iterations, seed, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
