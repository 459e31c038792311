// Whole-solve Langevin and pumped-Langevin kernel for Hopper (sm_90a),
// plain and Adam variants.
//
// Replaces the Pallas TPU kernels `_langevin_kernel`, `_langevin_adam_kernel`,
// `_pumped_langevin_kernel` and `_pumped_langevin_adam_kernel`
// (ccvm_tpu/ops/pallas_kernels.py:488, :585, :657 and :762).  One launch
// integrates every Euler-Maruyama step of a batch of independent
// trajectories, from c = 0:
//
//   scale = (u-l)/(2S);  x = c*scale + (u+l)/2;  w = one normal draw * noise_scale
//   Langevin:   g = -(x@Q + V)*scale
//               plain: c += (dt*fs)*g + (sigma*sqrt(dt))*w
//               Adam:  c += (dt*fs)*adam(g) + (sigma*sqrt(dt))*w
//   pumped:     p_i = pump*(i+1)/T (or pump);  g = -(x@Q)*scale - V*scale
//               plain: c += dt*((-1 + p_i - c^2)c + fs*g) + (sigma*sqrt(dt))*w
//               Adam:  c += dt*((-1 + p_i - c^2)c + fs*adam(g)) + (sigma*sqrt(dt))*w
//   c = clip(c, +-S) every step;  Adam's bias corrections are 1 - beta^(i+1).
//
// The order of every operation is the TPU kernels' (pallas_kernels.py:508-514,
// :680-688), which the plain version (ops/langevin_kernels.py) repeats.
//
// What bounds it on this card: arithmetic.  The one matvec is 2*B*N^2*T fp32
// flops, plus ~10-30*B*N*T elementwise flops and one Philox call per 4
// elements per step; at B=65536, N=70, T=15000 that is ~9.6e12 flop of
// matvec.  Q and the state never leave the chip, so the bytes (Q and V in,
// c out) are negligible.
//
// What this simple design does about it, as mf_solve.cu does:
//   * one thread block owns R trajectories for ALL iterations, in one launch;
//   * Q (zero-padded to NP x NP) lives in shared memory for the whole solve;
//     the block's x rows (one array) are rebuilt in shared memory each step;
//   * each thread owns a 4-row x 4-column tile of c (and of the two Adam
//     moments) in registers; IEEE fp32 FMAs on the CUDA cores (no TF32, no
//     mma); the draw is made after the matvec, one row of the tile at a time,
//     so its words are live only in the update;
//   * the padding columns (N..NP-1) meet zero rows of Q and a zero V; their
//     own noise is bounded by the per-step clamp, and they are not written;
//   * the per-step scalars (the pump, the bias corrections) are computed once
//     a step, outside the element loop;
//   * __launch_bounds__(256, 2) keeps two blocks on each SM (128 registers);
//   * noise: the Philox4x32-10 of ccvm_common.cuh, key = seed + instance,
//     counter = (step, row, column/4, stream); the grid is
//     (ceil(batch/R), instances).
// Specialisations are chosen at build time with -D flags by
// ccvm_tpu_torch/ops/build.py; each build exports ccvm_langevin_solve.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"

namespace {

using namespace ccvm;

constexpr int kMinBlocks = 2;

struct LangevinScalars {
  float pump, S, dt, sigma, fs, lo, hi, T;
  float alpha, beta1, one_minus_beta1, beta2, one_minus_beta2;
  float noise_scale;
};
static_assert(sizeof(LangevinScalars) == 14 * sizeof(float),
              "LangevinScalars layout");

template <bool PUMPED, bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN,
          bool PUMP_RATE_FLAG, bool NOISE, int RNG>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
langevin_solve_kernel(const float* __restrict__ q, const float* __restrict__ v,
                      float* __restrict__ c_out, int batch, int n,
                      int iterations, unsigned long long seed,
                      LangevinScalars p) {
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

  const float scale = (p.hi - p.lo) / (2.0f * p.S);
  const float mid = (p.hi + p.lo) / 2.0f;
  const float dt_fs = p.dt * p.fs;
  const float diffusion = p.sigma * sqrtf(p.dt);
  // Langevin adds V before scaling; pumped scales it on its own.
  float v_term[TC];
#pragma unroll
  for (int jj = 0; jj < TC; ++jj) {
    const int j = col0 + jj;
    const float vj = j < n ? v[(size_t)inst * n + j] : 0.0f;
    v_term[jj] = PUMPED ? vj * scale : vj;
  }
  const uint2 key = seed_key(seed, inst);

  float c[TR][TC], m1[TR][TC], m2[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) c[r][jj] = m1[r][jj] = m2[r][jj] = 0.0f;

  for (int i = 0; i < iterations; ++i) {
    const float fi1 = (float)i + 1.0f;

    // The step's x rows (padding columns meet zero rows of Q).
#pragma unroll
    for (int r = 0; r < TR; ++r)
      *reinterpret_cast<float4*>(xs + (lrow0 + r) * ks + col0) =
          make_float4(c[r][0] * scale + mid, c[r][1] * scale + mid,
                      c[r][2] * scale + mid, c[r][3] * scale + mid);
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

    const float pump_i = PUMP_RATE_FLAG ? p.pump * fi1 / p.T : p.pump;
    const float k1 = -1.0f + pump_i;
    float b1i = 1.0f, b2i = 1.0f;
    if (ADAM) {
      b1i = 1.0f - powf(p.beta1, fi1);
      if (!BETA2_ONE) b2i = 1.0f - powf(p.beta2, fi1);
    }

#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float w[TC];
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
          unsigned words[NS];
#pragma unroll
          for (int st = 0; st < NS; ++st) words[st] = word_of(wv[st], jj);
          w[jj] = normal_one<RNG>(words) * p.noise_scale;
        }
      }
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        const float cc = c[r][jj];
        float g = PUMPED ? -qx[r][jj] * scale - v_term[jj]
                         : -(qx[r][jj] + v_term[jj]) * scale;
        if (ADAM)
          g = adam<BETA2_ONE, ADD_ASSIGN>(g, m1[r][jj], m2[r][jj], b1i, b2i, p);
        float cn;
        if (PUMPED)
          cn = cc + p.dt * ((k1 - cc * cc) * cc + p.fs * g);
        else
          cn = cc + dt_fs * g;
        if (NOISE) cn = cn + diffusion * w[jj];
        c[r][jj] = clip(cn, p.S);
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
      if (j < n) c_out[base + j] = c[r][jj];
    }
  }
}

}  // namespace

#ifndef CCVM_PUMPED
#define CCVM_PUMPED 0
#endif
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

// q (I, n, n), v (I, n), c_out (I, batch, n): float32, contiguous, on the
// device; c_out is left as it is when iterations is 0.  scalars: 14 host
// floats in LangevinScalars order.  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch.
int ccvm_langevin_solve(const float* q, const float* v, float* c_out,
                        int num_instances, int batch, int n, int iterations,
                        unsigned long long seed, const float* scalars,
                        int rows_per_block, void* stream) {
  LangevinScalars p;
  memcpy(&p, scalars, sizeof(LangevinScalars));
  int threads;
  long long smem;
  if (ccvm::launch_shape(n, rows_per_block, 1, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = langevin_solve_kernel<
      CCVM_PUMPED != 0, CCVM_ADAM != 0, CCVM_BETA2_ONE != 0,
      CCVM_ADD_ASSIGN != 0, CCVM_PUMP_RATE_FLAG != 0, CCVM_NOISE != 0,
      CCVM_RNG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, num_instances);
  kernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, c_out, batch, n, iterations, seed, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
