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
// What bounds it on this card: operations.  The one matvec is 2*B*N^2*T
// fp32 flops (9.6e12 at B=65536, N=70, T=15000: 144 ms on the fp32 CUDA
// cores at 66.9 TFLOP/s), the elementwise work 11-30 flops per element and
// step, and one Philox call per 4 elements per step.  Q and the state never
// leave the chip, so the bytes (Q and V in, c out) are negligible.
//
// Why the matvec stays on the fp32 CUDA cores.  The drift is linear in c, so
// a change of the matvec's rounding grows along the unstable directions of
// x.Q.x until the clamp at +-S stops it, and chip_smoke.py holds the kernel
// to its plain version at 2e-3 after 15,000 steps.  The tensor-core models
// of ccvm_tpu_torch/tools/tc_model.py (--family langevin, on the card, at
// chip_smoke.py's seed) kept every hold to 1,000 steps but DL's truncating
// chain, which missed 2e-3 there; over 15,000 steps 3xTF32 per k-tile,
// 4xTF32 per k-tile and centred 3xTF32 per k-tile each kept Langevin and
// Langevin-Adam within 2e-3 but read 6.0e-3, 8.4e-3 and 1.1e-2 for
// pumped-Adam (PERF.md).  So the template, which all four kernels share,
// keeps the plain matmul's own order, one fp32 FMA chain per
// output over k = 0, 1, ... (cuBLAS's on the H100 too), and spells out every
// elementwise product and sum in the plain version's order: it equals the
// plain version bit for bit where cuBLAS sums in that order (the Adam
// kernels to an ulp, where alpha mhat / (sqrt(vhat) + eps) takes the
// hardware's square root and division).
//
// What this design does about the rest:
//   * one thread block owns R trajectories for ALL iterations, in one
//     launch; Q (zero-padded to NP x NP, NP = N padded to 8, fixed at build
//     time) lives in shared memory for the whole solve, and the block's x
//     rows are rebuilt each step into the other of two buffers: one block
//     barrier a step;
//   * the matvec reads its operands from shared memory, whose pipe serves
//     128 bytes a clock against the fp32 pipe's 128 FMAs: a thread tile of
//     TR rows x TC columns reads TR + TC floats per TR*TC FMAs, so the 4 x 4
//     tile of the earlier design (and of mf_solve.cu) waits on its loads
//     twice as long as on its FMAs.  Here a thread owns TC = NP/8 columns
//     (9 at N=70) of 8 rows (Adam: 4) with c (and Adam's first moment) in
//     registers: 17 floats per 72 FMAs (Adam 13 per 36); Adam's second
//     moment lives in the thread's own slots of shared memory (in registers
//     too it spilled, and both there cost Adam 6%);
//   * 8 column groups and 16 row groups make a block of 128 threads, two
//     blocks per SM: 8 warps, two to each quarter of the SM, so the quarters
//     carry equal work, and up to 255 registers a thread.  At batch 65536,
//     N=70 the grid is 512 blocks (Adam 1,024), 1.94 (3.88) waves of the 132
//     SMs;
//   * a thread's rows are every 16th row of the block, so the x rows that a
//     half warp reads lie 76 floats apart, on distinct banks; its columns
//     are float4s of 4 columns, every 8th (cg, cg + 8, ...), then one column
//     of each 8-column stripe beyond them (at N=70: columns 4cg..4cg+3,
//     32+4cg..35+4cg and 64+cg), so a quarter warp's Q reads fall on
//     distinct banks, each a broadcast to the warp's 4 row groups, and each
//     float4 of columns takes one Philox call's four words;
//   * no division, pow or schedule in the step loop: the per-step scalars
//     (the pump p_i, k1 = -1 + p_i, Adam's 1 - beta^(i+1) and their
//     reciprocals) come from a table that the wrapper fills on the device
//     with the plain version's own float32 operations
//     (ops/langevin_kernels.py _step_table), and the per-solve constants
//     (scale, (u+l)/2, dt*fs, sigma*sqrt(dt)) are kernel parameters taken on
//     the host; Adam's divisions by its bias corrections are div_rn
//     (ccvm_common.cuh), the IEEE quotient by a known divisor;
//   * noise: the Philox4x32-10 of ccvm_common.cuh, key = seed + instance,
//     counter = (step, row, column/4, stream); a thread draws the calls whose
//     words its columns take (three at N=70, where four threads share the
//     call of a stripe's column; at N=20, where every column is a stripe
//     column, one call an element); the grid is (ceil(batch/R), instances).
// Three build flags serve the façades' evolution sampling and per-variable
// S (a whole solve with a scalar S sets none, and its code is as above):
//   * CCVM_SEG 1, a segment launch (ccvm_common.cuh Segment): c and Adam's
//     two moments are read at the start (the second into its shared-memory
//     slots) and the moments written back; the Philox counter is the
//     absolute step;
//   * CCVM_COLS 1, a per-column S (an (n,) vector): scale_j = (u-l)/(2 S_j)
//     in x and in the drift (and pumped's V scale) and the clamp to +-S_j,
//     S_j and scale_j read from shared memory (two more floats a column
//     there, where 18 more registers a thread would not fit beside the
//     tile);
//   * CCVM_ELEM 1 (with CCVM_COLS), a per-element S: the wrapper's (2, rows,
//     NP) array of S_ij and scale_ij = (u-l)/(2 S_ij) on the card (rows the
//     batch padded to whole blocks, columns to NP; every instance of a
//     stacked launch reads the same), read from global memory (L2 holds
//     both arrays, 36.7 MB at batch 65536, N=70) where each step takes them:
//     a thread's tile is 72 elements (Adam 36), whose S and scale would take
//     144 (72) registers beside the tile's c and sums (234 at N=20 already),
//     so none is kept in registers or shared memory.  Pumped's V scale_ij
//     is the product the per-column build takes once, taken each step, so
//     equal rows give the per-column build's result bit for bit.
// For a mesh (ccvm_tpu_torch/parallel): every launch takes a row base, the
// global row of its trajectory 0; its grid starts that many rows early and
// the blocks below return at once (ccvm_common.cuh Segment), so a
// data-parallel rank's rows draw what those rows of one launch draw; and
// CCVM_EXT 1 builds one step of a tensor-parallel
// solve instead of the whole-solve kernel (langevin_step_kernel, ccvm_langevin_step):
// the matvec comes from a buffer, reduce-scattered by the engine, and the
// step takes the whole solve's arithmetic at the element's global row and
// column; what bounds it is bytes (the state, the matvec and the next
// input, once each).
// Specialisations are chosen at build time with -D flags by
// ccvm_tpu_torch/ops/build.py (the pump schedule is in the table, so one
// library serves both); each build exports ccvm_langevin_solve and
// ccvm_langevin_blocks_per_sm.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"

// Probe of ccvm_tpu_torch/tools/breakdown.py, never set by the solvers'
// builds: CCVM_MATVEC 0 takes the matvec out (its sums stay 0).
#ifndef CCVM_MATVEC
#define CCVM_MATVEC 1
#endif

namespace {

using namespace ccvm;

constexpr int kGroups = 8;      // column groups a block
constexpr int kRowGroups = 16;  // row groups a block
constexpr int kThreads = kGroups * kRowGroups;
constexpr int kMaxCols = 16;    // TC <= 16: N <= 128
// Rows a thread owns: 8 (Adam 4) up to 9 columns, half that beyond.
__host__ __device__ constexpr int rows_per_thread(bool adam, int cols) {
  return (adam ? 4 : 8) / (cols > 9 ? 2 : 1);
}

// A thread's TC columns: its first A = 4 floor(TC/4) are float4s of
// columns, groups cg, cg + 8, ... (column 4 (cg + 8 f) + word), and the
// rest one column of each 8-column stripe beyond them (8A + cg + 8e).
template <int TC>
struct Columns {
  static constexpr int A = TC / 4 * 4;
  static constexpr int kCalls = A / 4 + (TC - A);  // Philox calls a row
  __device__ static int col(int cg, int jj) {
    return jj < A ? 4 * (cg + 8 * (jj / 4)) + jj % 4 : 8 * A + cg + 8 * (jj - A);
  }
  // The Philox column group (counter word 2) of call `call`.
  __device__ static int group(int cg, int call) {
    return call < A / 4 ? cg + 8 * call : 2 * A + 2 * (call - A / 4) + cg / 4;
  }
};

// The solve's scalars and its per-solve constants, taken once on the host
// in float32 as the plain version rounds them (ops/langevin_kernels.py
// _scalars).  Kernel parameters live in the constant bank, so they cost the
// step loop no registers.
struct LangevinScalars {
  float S, dt, fs, scale, mid, dt_fs, diffusion, noise_scale;
  float alpha, beta1, one_minus_beta1, beta2, one_minus_beta2;
};
static_assert(sizeof(LangevinScalars) == 13 * sizeof(float),
              "LangevinScalars layout");

// The step's scalars, from the (iterations, 8) table: k1 = -1 + p_i,
// 1 - beta1^(i+1), its reciprocal, 1 - beta2^(i+1), its reciprocal, and
// three zeros that pad a row to two float4s.
struct StepScalars {
  float k1, b1i, inv_b1i, b2i, inv_b2i;
};

template <bool ADAM, bool BETA2_ONE>
__device__ __forceinline__ StepScalars step_scalars(const float4* __restrict__ steps,
                                                    int i) {
  const float4 a = __ldg(steps + 2 * i);
  StepScalars st{a.x, 1.0f, 1.0f, 1.0f, 1.0f};
  if (ADAM) {
    st.b1i = a.y;
    st.inv_b1i = a.z;
    if (!BETA2_ONE) {
      st.b2i = a.w;
      st.inv_b2i = __ldg(reinterpret_cast<const float*>(steps + 2 * i + 1));
    }
  }
  return st;
}

// One Euler-Maruyama step of one element of c from its matvec sum qx, its
// column's V term vt (Langevin: V; pumped: V*scale), scale and S, and its
// draw w, in the plain version's order of operations.
template <bool PUMPED, bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE>
__device__ __forceinline__ float element_step(float c, float qx, float vt, float scale,
                                              float S, float w, float& m, float& v,
                                              const StepScalars& st,
                                              const LangevinScalars& p) {
  float cn;
  if (PUMPED) {
    float g = __fsub_rn(__fmul_rn(-qx, scale), vt);
    if (ADAM)
      g = adam<BETA2_ONE, ADD_ASSIGN>(g, m, v, st.b1i, st.inv_b1i, st.b2i, st.inv_b2i, p);
    const float pump_drift = __fmul_rn(__fsub_rn(st.k1, __fmul_rn(c, c)), c);
    cn = __fadd_rn(c, __fmul_rn(p.dt, __fadd_rn(pump_drift, __fmul_rn(p.fs, g))));
  } else {
    float g = __fmul_rn(-__fadd_rn(qx, vt), scale);
    if (ADAM)
      g = adam<BETA2_ONE, ADD_ASSIGN>(g, m, v, st.b1i, st.inv_b1i, st.b2i, st.inv_b2i, p);
    cn = __fadd_rn(c, __fmul_rn(p.dt_fs, g));
  }
  if (NOISE) cn = __fadd_rn(cn, __fmul_rn(p.diffusion, w));
  return clip(cn, S);
}

// x of an element, c*scale + (u+l)/2 rounded as the plain version rounds it.
__device__ __forceinline__ float x_of(float c, float scale, const LangevinScalars& p) {
  return __fadd_rn(__fmul_rn(c, scale), p.mid);
}

// The launch rule (ops/build.py langevin_launch_shape states the same):
// threads, trajectories a block and shared-memory bytes; non-zero when N
// does not fit.  Shared memory: Q (NP x NP), with a per-column S its S_j and
// scale_j (2 NP), two x buffers of R rows of stride NP + 4, and for Adam
// each thread's second moments of its tile.
__host__ __device__ inline int lgv_launch_shape(int n, bool adam, bool per_col,
                                                int* threads, int* rows,
                                                long long* smem) {
  const int np = (n + kGroups - 1) / kGroups * kGroups;
  const int cols = np / kGroups;
  *threads = kThreads;
  *rows = kRowGroups * rows_per_thread(adam, cols);
  *smem = 4LL * np * np + (per_col ? 8LL * np : 0) + 4LL * 2 * *rows * (np + 4) +
          (adam ? 4LL * rows_per_thread(adam, cols) * cols * kThreads : 0);
  return (n >= 1 && cols <= kMaxCols && *smem <= 232448) ? 0 : 1;
}

template <bool PUMPED, bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE, int RNG,
          int NP, bool COLS, bool SEG, bool ELEM>
__global__ void __launch_bounds__(kThreads, 2)
langevin_solve_kernel(const float* __restrict__ q, const float* __restrict__ v,
                      const float4* __restrict__ steps, float* __restrict__ c_out,
                      int batch, int n, int iterations, unsigned long long seed,
                      LangevinScalars p, const float* __restrict__ cols, Segment sg) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < sg.first_block) return;  // rows below the launch's
  constexpr int TC = NP / kGroups;
  constexpr int TR = rows_per_thread(ADAM, TC);
  constexpr int R = kRowGroups * TR;
  constexpr int ks = NP + 4;  // x row stride
  using Cols = Columns<TC>;
  float* qs = smem;             // (NP, NP), zero-padded
  float* s_col = qs + NP * NP;  // COLS: (NP) S_j, then (NP) scale_j
  float* xbuf = s_col + (COLS ? 2 * NP : 0);  // two (R, ks) buffers
  float* own = xbuf + 2 * R * ks;  // Adam: (TR, TC, threads) second moments

  const int inst = blockIdx.y;
  const int tid = threadIdx.x;
  const int cg = tid % kGroups;
  const int rg = tid / kGroups;  // rows rg, rg + 16, ... of the block
  const int grow0 = blockIdx.x * R + rg;

  const float* qi = q + (size_t)inst * n * n;
  for (int e = tid; e < NP * NP; e += kThreads) {
    const int k = e / NP, j = e % NP;
    qs[e] = (k < n && j < n) ? qi[k * n + j] : 0.0f;
  }
  if (COLS && !ELEM)
    for (int j = tid; j < NP; j += kThreads) {
      s_col[j] = j < n ? cols[j] : 1.0f;
      s_col[NP + j] = j < n ? cols[n + j] : 0.0f;
    }
  // The S and scale of row r's column jj: the solve's, (COLS) the column's,
  // or (ELEM) the element's, from the (2, rows, NP) array.
  const size_t elem_rows = (size_t)gridDim.x * R * NP;
  const auto elem = [&](int a, int r, int jj) {
    return __ldg(cols + a * elem_rows + (size_t)(grow0 + r * kRowGroups) * NP +
                 Cols::col(cg, jj));
  };
  const auto S_of = [&](int r, int jj) {
    return ELEM ? elem(0, r, jj) : COLS ? s_col[Cols::col(cg, jj)] : p.S;
  };
  const auto scale_of = [&](int r, int jj) {
    return ELEM ? elem(1, r, jj) : COLS ? s_col[NP + Cols::col(cg, jj)] : p.scale;
  };
  // Langevin adds V to x@Q before scaling; pumped scales it on its own, as
  // the plain version's V * scale (ELEM: each step, by the element's).
  float vt[TC];
#pragma unroll
  for (int jj = 0; jj < TC; ++jj) {
    const int j = Cols::col(cg, jj);
    const float vj = j < n ? v[(size_t)inst * n + j] : 0.0f;
    vt[jj] = PUMPED && !ELEM
                 ? __fmul_rn(vj, COLS ? (j < n ? cols[n + j] : 0.0f) : p.scale)
                 : vj;
  }
  const uint2 key = seed_key(seed, inst);

  // c (and Adam's first moment) of the thread's rows and columns in
  // registers, Adam's second moment in its own slots (conflict-free); x of
  // the first step (c = 0, or a segment's c) into its buffer.
  float c[TR][TC], m1[ADAM ? TR : 1][TC];
  const auto m2 = [&](int r, int jj) -> float& { return own[(r * TC + jj) * kThreads + tid]; };
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      c[r][jj] = 0.0f;
      if (ADAM) m1[r][jj] = m2(r, jj) = 0.0f;
    }
  if (SEG && sg.in[0] != nullptr) {
    // The state at step `start`: c, m, v of the tile, zero beyond n and the
    // batch.
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = grow0 + r * kRowGroups;
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        const int j = Cols::col(cg, jj);
        const size_t e = ((size_t)inst * batch + row) * n + j;
        const bool in = row < batch && j < n;
        c[r][jj] = in ? sg.in[0][e] : 0.0f;
        if (ADAM) {
          m1[r][jj] = in ? sg.in[1][e] : 0.0f;
          if (!BETA2_ONE) m2(r, jj) = in ? sg.in[2][e] : 0.0f;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int jj = 0; jj < TC; ++jj)
      xbuf[(rg + r * kRowGroups) * ks + Cols::col(cg, jj)] =
          x_of(c[r][jj], scale_of(r, jj), p);
  __syncthreads();  // Q and the first x rows are in place

  for (int i = 0; i < iterations; ++i) {
    const float* xs = xbuf + (i & 1) * R * ks;
    float* xn = xbuf + ((i + 1) & 1) * R * ks;

    // x @ Q: one fp32 FMA chain per output over k = 0, 1, ..., the plain
    // matmul's order; a thread reads its columns of 2 rows of Q (float4s and
    // single columns) and a float2 of x per row for each 2 k.
    float acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) acc[r][jj] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < (CCVM_MATVEC ? NP : 0); k += 2) {
      float q0[TC], q1[TC];
#pragma unroll
      for (int f = 0; f < Cols::A / 4; ++f) {
        const float4 a0 = *reinterpret_cast<const float4*>(qs + k * NP + Cols::col(cg, 4 * f));
        const float4 a1 =
            *reinterpret_cast<const float4*>(qs + (k + 1) * NP + Cols::col(cg, 4 * f));
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          q0[4 * f + w] = comp(a0, w);
          q1[4 * f + w] = comp(a1, w);
        }
      }
#pragma unroll
      for (int jj = Cols::A; jj < TC; ++jj) {
        q0[jj] = qs[k * NP + Cols::col(cg, jj)];
        q1[jj] = qs[(k + 1) * NP + Cols::col(cg, jj)];
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float2 a =
            *reinterpret_cast<const float2*>(xs + (rg + r * kRowGroups) * ks + k);
#pragma unroll
        for (int jj = 0; jj < TC; ++jj) {
          acc[r][jj] = __fmaf_rn(a.x, q0[jj], acc[r][jj]);
          acc[r][jj] = __fmaf_rn(a.y, q1[jj], acc[r][jj]);
        }
      }
    }

    const StepScalars st = step_scalars<ADAM, BETA2_ONE>(steps, i);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      constexpr int NS = streams_one_of(RNG);
      uint4 words4[NOISE ? Cols::kCalls : 1][NS];
      if (NOISE) {
        const unsigned row = (unsigned)(grow0 + r * kRowGroups);
#pragma unroll
        for (int call = 0; call < Cols::kCalls; ++call)
#pragma unroll
          for (int st_ = 0; st_ < NS; ++st_)
            words4[call][st_] = philox4x32_10(
                make_uint4((unsigned)(SEG ? i + sg.start : i), row,
                           (unsigned)Cols::group(cg, call), (unsigned)st_),
                key);
      }
      float xr[TC];
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        float w = 0.0f;
        if (NOISE) {
          // A float4 column takes its word of its call; a stripe column
          // word cg % 4 of its own call.
          const int call = jj < Cols::A ? jj / 4 : Cols::A / 4 + (jj - Cols::A);
          unsigned words[NS];
#pragma unroll
          for (int st_ = 0; st_ < NS; ++st_)
            words[st_] = word_of(words4[call][st_], jj < Cols::A ? jj % 4 : cg % 4);
          w = __fmul_rn(normal_one<RNG>(words), p.noise_scale);
        }
        float unused = 0.0f, v2 = 0.0f;
        if (ADAM && !BETA2_ONE) v2 = m2(r, jj);
        const float sc = scale_of(r, jj);
        c[r][jj] = element_step<PUMPED, ADAM, BETA2_ONE, ADD_ASSIGN, NOISE>(
            c[r][jj], acc[r][jj], PUMPED && ELEM ? __fmul_rn(vt[jj], sc) : vt[jj], sc,
            S_of(r, jj), w, ADAM ? m1[ADAM ? r : 0][jj] : unused, v2, st, p);
        if (ADAM && !BETA2_ONE) m2(r, jj) = v2;
        xr[jj] = x_of(c[r][jj], sc, p);
      }
      float* xw = xn + (rg + r * kRowGroups) * ks;
#pragma unroll
      for (int f = 0; f < Cols::A / 4; ++f)
        *reinterpret_cast<float4*>(xw + Cols::col(cg, 4 * f)) =
            make_float4(xr[4 * f], xr[4 * f + 1], xr[4 * f + 2], xr[4 * f + 3]);
#pragma unroll
      for (int jj = Cols::A; jj < TC; ++jj) xw[Cols::col(cg, jj)] = xr[jj];
    }
    __syncthreads();  // the next step's x rows are written, and this step's
                      // reads of the other buffer are done
  }

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = grow0 + r * kRowGroups;
    if (row >= batch) continue;
    const size_t base = ((size_t)inst * batch + row) * n;
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      const int j = Cols::col(cg, jj);
      if (j < n) {
        c_out[base + j] = c[r][jj];
        if (SEG && ADAM) {
          sg.out[0][base + j] = m1[ADAM ? r : 0][jj];
          sg.out[1][base + j] = BETA2_ONE ? 0.0f : m2(r, jj);
        }
      }
    }
  }
}

// One step of a tensor-parallel Langevin or pumped-Langevin solve
// (ccvm_tpu_torch/parallel/tp.py) on a rank's (batch, nl) shard of the
// state, one thread an element.  The matvec is not computed here: mv
// (batch, nl) holds the reduce-scattered x @ Q at the shard's rows and
// columns, which the engine's matmul and collective made from x.  The step
// is element_step, the whole solve's arithmetic (scalar S), at the draw of
// the element's global row and column; it writes the next step's matvec
// input x = c scale + (u+l)/2 into x_out (batch, nl).  step < 0 writes only
// that, for the engine's first matvec.  state is (c[, m, v]), each
// (batch, nl), updated in place.
template <bool PUMPED, bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE, int RNG>
__global__ void __launch_bounds__(256)
langevin_step_kernel(const float* __restrict__ mv, const float* __restrict__ v,
                     const float4* __restrict__ steps, float* __restrict__ state,
                     float* __restrict__ x_out, int batch, int nl, int col_base,
                     int row_base, int step, unsigned long long seed, LangevinScalars p) {
  const size_t count = (size_t)batch * nl;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const int j = (int)(e % nl);
  float c = state[e];
  if (step >= 0) {
    const StepScalars st = step_scalars<ADAM, BETA2_ONE>(steps, step);
    float w = 0.0f;
    if (NOISE) {
      constexpr int NS = streams_one_of(RNG);
      unsigned words[NS];
      element_words<NS>(words, step, row_base + (int)(e / nl), col_base + j, seed);
      w = __fmul_rn(normal_one<RNG>(words), p.noise_scale);
    }
    float m = ADAM ? state[count + e] : 0.0f, v2 = ADAM ? state[2 * count + e] : 0.0f;
    c = element_step<PUMPED, ADAM, BETA2_ONE, ADD_ASSIGN, NOISE>(
        c, mv[e], PUMPED ? __fmul_rn(v[j], p.scale) : v[j], p.scale, p.S, w, m, v2, st, p);
    state[e] = c;
    if (ADAM) {
      state[count + e] = m;
      state[2 * count + e] = v2;
    }
  }
  x_out[e] = x_of(c, p.scale, p);
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
#ifndef CCVM_NOISE
#define CCVM_NOISE 1
#endif
#ifndef CCVM_RNG
#define CCVM_RNG 0
#endif
#ifndef CCVM_NP
#define CCVM_NP 72
#endif
#ifndef CCVM_COLS
#define CCVM_COLS 0
#endif
#ifndef CCVM_SEG
#define CCVM_SEG 0
#endif
#ifndef CCVM_ELEM
#define CCVM_ELEM 0
#endif
#ifndef CCVM_EXT
#define CCVM_EXT 0
#endif

#if CCVM_EXT

namespace {

auto const kStep =
    &langevin_step_kernel<CCVM_PUMPED != 0, CCVM_ADAM != 0, CCVM_BETA2_ONE != 0,
                          CCVM_ADD_ASSIGN != 0, CCVM_NOISE != 0, CCVM_RNG>;

}  // namespace

extern "C" {

// One step of a tensor-parallel solve (langevin_step_kernel): mv
// (batch, nl) (unread when step < 0), v (nl) the shard's V, steps the whole
// solve's (total, 8) table, state (1 or 3, batch, nl) updated in place,
// x_out (batch, nl): float32, contiguous, on the device.  The shard's row 0
// and column 0 are the global row_base and col_base.  scalars: 13 host
// floats in LangevinScalars order.  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch.
int ccvm_langevin_step(const float* mv, const float* v, const float* steps, float* state,
                       float* x_out, int batch, int nl, int col_base, int row_base,
                       int step, int total, unsigned long long seed,
                       const float* scalars, void* stream) {
  LangevinScalars p;
  memcpy(&p, scalars, sizeof(LangevinScalars));
  if (batch < 1 || nl < 1 || step >= total || (step >= 0 && mv == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)batch * nl;
  kStep<<<(unsigned)((count + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      mv, v, reinterpret_cast<const float4*>(steps), state, x_out, batch, nl, col_base,
      row_base, step, seed, p);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else

namespace {

constexpr bool kAdam = CCVM_ADAM != 0;
constexpr bool kCols = CCVM_COLS != 0;
constexpr bool kSeg = CCVM_SEG != 0;
constexpr bool kElem = CCVM_ELEM != 0;
static_assert(!kElem || kCols, "a per-element S is a build of the per-column one");
static_assert(CCVM_NP % kGroups == 0 && CCVM_NP >= kGroups && CCVM_NP <= kGroups * kMaxCols,
              "NP: N padded to a multiple of 8, at most 128");
auto const kKernel =
    &langevin_solve_kernel<CCVM_PUMPED != 0, kAdam, CCVM_BETA2_ONE != 0,
                           CCVM_ADD_ASSIGN != 0, CCVM_NOISE != 0, CCVM_RNG, CCVM_NP,
                           kCols, kSeg, kElem>;

// lgv_launch_shape for this build's problem size class.
int launch_shape(int n, int* threads, int* rows, long long* smem) {
  if ((n + kGroups - 1) / kGroups * kGroups != CCVM_NP) return 1;
  return lgv_launch_shape(n, kAdam, kCols, threads, rows, smem);
}

}  // namespace

extern "C" {

// q (I, n, n), v (I, n), steps (total, 8), c_out (I, batch, n): float32,
// contiguous, on the device.  scalars: 13 host floats in LangevinScalars
// order.  cols: the (2, n) per-column S_j and scale_j of a CCVM_COLS build,
// the (2, rows, NP) S_ij and scale_ij of a CCVM_ELEM one (rows: the batch
// padded to whole blocks), else unused.  seg: a host Segment of a CCVM_SEG build (state in c, m, v;
// moments out m, v), else nullptr.  row_base: the global row of trajectory
// 0 (a data-parallel rank's first row; a multiple of the block's rows, and
// one instance): c_out and seg's arrays hold its rows only, and a
// CCVM_ELEM cols array has row_base leading rows (ccvm_common.cuh
// Segment).  Launches on `stream`, does not synchronise, and returns the
// cudaError_t of the launch.
int ccvm_langevin_solve(const float* q, const float* v, const float* steps,
                        float* c_out, int num_instances, int batch, int n,
                        int iterations, unsigned long long seed,
                        const float* scalars, int rows_per_block, void* stream,
                        const float* cols, const void* seg, int row_base) {
  LangevinScalars p;
  memcpy(&p, scalars, sizeof(LangevinScalars));
  Segment sg = {};
  sg.total = iterations;
  if (seg != nullptr) memcpy(&sg, seg, sizeof(Segment));
  int threads, rows;
  long long smem;
  if ((seg != nullptr) != kSeg || (kCols && cols == nullptr) ||
      launch_shape(n, &threads, &rows, &smem) || rows != rows_per_block || row_base < 0 ||
      row_base % rows != 0 || (row_base != 0 && num_instances != 1))
    return (int)cudaErrorInvalidConfiguration;
  // Rows indexed globally (ccvm_common.cuh Segment): the grid starts
  // row_base / rows blocks early and the arrays are shifted back.
  sg.first_block = row_base / rows;
  for (int a = 0; a < 6; ++a) {
    sg.in[a] = shifted(sg.in[a], row_base, n);
    sg.out[a] = shifted(sg.out[a], row_base, n);
  }
  c_out = shifted(c_out, row_base, n);
  batch += row_base;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows - 1) / rows, num_instances);
  kKernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, reinterpret_cast<const float4*>(steps + 8 * (size_t)sg.start), c_out, batch, n,
      iterations, seed, p, cols, sg);
  return (int)cudaGetLastError();
}

// Blocks of this specialisation the card keeps resident per SM at problem
// size n (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns a
// cudaError_t.
int ccvm_langevin_blocks_per_sm(int n, int* blocks) {
  int threads, rows;
  long long smem;
  if (launch_shape(n, &threads, &rows, &smem))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kKernel, threads,
                                                            (size_t)smem);
}

}  // extern "C"

#endif  // CCVM_EXT
