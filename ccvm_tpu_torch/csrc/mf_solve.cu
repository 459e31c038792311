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
// What bounds it on this card: operations.  The one matvec is 2*B*N^2*T
// fp32 flops (9.6e12 at B=65536, N=70, T=15000: 144 ms on the fp32 CUDA
// cores at 66.9 TFLOP/s), the elementwise work about 44*B*N*T more (Adam
// 62), and one Philox call per 4 elements per step.  Q and the state never
// leave the chip, so the bytes (Q and V in, mu, mt and sigma out) are
// negligible.
//
// Why the matvec stays on the fp32 CUDA cores.  MF's state sits near
// |mu| = 270 (S 130, feedback_scale 32000 at N=70), where one fp32 ulp is
// 3.05e-5: the hold against the plain version, 1e-4, is three ulps, and
// feedback_scale turns a change of the matvec's rounding into a shift of
// mu's equilibrium of the same size.  The design asked a tensor-core
// scheme's CPU model (ccvm_tpu_torch/tools/tc_model.py) to stay within
// 5e-5 of the plain solve, and none did; the plain matmul's own order, one
// fp32 FMA chain over k = 0, 1, ... (cuBLAS's too on the H100), lands at
// 0.  So the kernel keeps that chain, and takes out what else held the
// CUDA-core design back (per-element divisions, per-step exp and pow,
// spills, a ragged last wave).  On the card the 4xTF32 per-k-tile model
// holds 1e-4 in every check (PERF.md), so a tensor-core MF matvec is not
// ruled out.
//
// What this design does about the rest:
//   * one thread block owns R trajectories for ALL iterations, in one
//     launch; Q (zero-padded to NP x NP, NP fixed at build time) lives in
//     shared memory for the whole solve, and each thread owns a 4-row x
//     4-column tile: mu in registers, sigma (and for Adam its two moments
//     and mu) in its own float4s of shared memory, so no main-path
//     specialisation spills at the 96 registers that 18 warps per SM leave;
//   * the x rows are rebuilt in shared memory each step, double-buffered:
//     one block barrier a step, after the writes (a thread writes the other
//     buffer next step, and the barrier between proves every read of this
//     one done).  One buffer and a second barrier cost MF 1.0% (32.37
//     against 32.05 us/step at the main shape, five rounds each,
//     tools/mf_breakdown.py on an H100 80GB HBM3 at 700 W); Adam, short of
//     shared memory, pays it;
//   * no division, exp or pow of a per-step constant in the step loop: the
//     per-step scalars (sqrt(1/(4 j_i)), k1, 1 + j_i, -2 j_i, sqrt(j_i),
//     Adam's 1 - beta^(i+1) and their reciprocals) come from a table that
//     the wrapper fills on the device with the plain version's own float32
//     operations, and the per-solve constants (1/S, sqrt(dt), 1/sqrt(dt),
//     u-l, u+l, g^2, 2(3g^2), 2g^2, -0.25(u-l)) are kernel parameters taken
//     on the host;
//   * each division by S, sqrt(dt) or 1 - beta^(i+1) is a product by the
//     divisor's reciprocal with one FMA correction (div_rn in
//     ccvm_common.cuh), which rounds as the IEEE division does, and the
//     element step spells out every product and sum (no contracted
//     multiply-add), in the plain version's order.  So MF equals the plain
//     version bit for bit where the plain matmul sums in the same order;
//     Adam's per-element alpha mhat / (sqrt(vhat) + eps) takes the
//     hardware's approximations (the IEEE sequences' slow-path calls made
//     it spill), an ulp or so from the plain version;
//   * 64 trajectories (16 row groups) a block at N <= 72, two blocks per SM
//     (18 warps); at batch 65536, N=70 the grid is 1,024 blocks, 3.88 waves
//     of the 132 SMs.  The matvec's shared-memory loads (eight float4s per
//     64 FMAs) hold the load pipe about twice as long as the FMAs hold
//     theirs (ccvm_tpu_torch/tools/mf_breakdown.py times the kernel without
//     its matvec);
//   * the draw of a popcount transform is kept as its popcount, a byte, so
//     the tile's 16 draws take 4 registers across the matvec;
//   * noise: the Philox4x32-10 of ccvm_common.cuh, key = seed + instance,
//     counter = (step, row, column/4, stream); the grid is
//     (ceil(batch/R), instances).
// Three build flags serve the façades' evolution sampling and per-variable
// S (a whole solve with a scalar S sets none, and its code is as above):
//   * CCVM_SEG 1, a segment launch (ccvm_common.cuh Segment): mu, sigma and
//     Adam's two moments are read at the start and the moments written
//     back; the Philox counter is the absolute step, and mt_out is written
//     by the solve's last step only (so by its last segment);
//   * CCVM_COLS 1, a per-column S: S_j and its reciprocal inv_j = 1/S_j
//     rounded to nearest (taken by the wrapper with the plain version's
//     float32 division, a (2, n) array) in shared memory.  The clamp of mt
//     takes S_j; x = mt_c span / S_j + (u+l), the feedback's division by S_j
//     and V span / (2 S_j) are div_rn's, by S_j with inv_j (2 S_j with
//     inv_j / 2, the same quotient's significand), as the scalar S's are.
//     div_rn rounds as the IEEE division for every dividend where
//     tests/test_torch_mf_redesign.py's emulation proves it per divisor
//     (S_j of the per-variable tests and of chip_smoke.py's phases 12 and
//     15, S = 20 and 130); for any other divisor the build is held against
//     the plain version at chip_smoke.py's 1e-4.  (__fdiv_rn's slow-path
//     call spills at 96 registers.);
//   * CCVM_ELEM 1 (with CCVM_COLS), a per-element S: the wrapper's (2,
//     rows, NP) array of S_ij and inv_ij on the card (rows the batch padded
//     to whole blocks, columns to NP; every instance of a stacked launch
//     reads the same), read from global memory (L2) where the step takes
//     them, a float4 of each a row in each of the step's two phases: a
//     thread's 16 elements of both would take 32 of its 96 registers.  The
//     V term V_j span / (2 S_ij) is taken each step from V_j span (shared
//     memory) by div_rn, as the per-column build takes it once.  Every
//     division is div_rn, so equal rows give the per-column build's result
//     bit for bit.
// For a mesh (ccvm_tpu_torch/parallel): every launch takes a row base, the
// global row of its trajectory 0; its grid starts that many rows early and
// the blocks below return at once (ccvm_common.cuh Segment), so a
// data-parallel rank's rows draw what those rows of one launch draw; and
// CCVM_EXT 1 builds one step of a tensor-parallel
// solve instead of the whole-solve kernel (mf_step_kernel, ccvm_mf_step):
// the matvec comes from a buffer, reduce-scattered by the engine, and the
// step takes the whole solve's arithmetic at the element's global row and
// column; what bounds it is bytes (the state, the matvec and the next
// input, once each).
// Specialisations are chosen at build time with -D flags by
// ccvm_tpu_torch/ops/build.py; each build exports ccvm_mf_solve and
// ccvm_mf_blocks_per_sm.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"

// Probes of ccvm_tpu_torch/tools/mf_breakdown.py, never set by the solvers'
// builds: CCVM_MATVEC 0 takes the matvec out (its sums stay 0), and
// CCVM_X_BUFFERS 1 or 2 overrides the launch rule's number of x buffers.
#ifndef CCVM_MATVEC
#define CCVM_MATVEC 1
#endif
#ifndef CCVM_X_BUFFERS
#define CCVM_X_BUFFERS 0
#endif

namespace {

using namespace ccvm;

constexpr float kSafetyBound = 1.0e5f;  // _MF_SAFETY_BOUND
// 16 row groups of 4 trajectories a block where N allows (18 column groups
// at N=70: 288 threads), two blocks per SM: 18 warps at <= 96 registers.
constexpr int kMaxRowGroups = 16;
constexpr int kThreads = 288;
constexpr int kMinBlocks = 2;

// The solve's scalars, and its per-solve constants taken once on the host
// in float32 (ops/mf_kernels.py _scalars).  Kernel parameters live in the
// constant bank, so they cost the step loop no registers.
struct MFScalars {
  float pump, S, dt, j, fs, g, lo, hi, T;
  float alpha, beta1, one_minus_beta1, beta2, one_minus_beta2;
  float noise_scale;
  float inv_S, sqrt_dt, inv_sqrt_dt, span, mid, g_sq, g_sq6, g_sq2, fbspan;
};
static_assert(sizeof(MFScalars) == 24 * sizeof(float), "MFScalars layout");

// The step's scalars, from the (iterations, 12) table the wrapper fills with
// the plain version's own float32 operations (ops/mf_kernels.py
// _step_table): sqrt(1/(4 j_i)), k1, 1 + j_i, -2 j_i, sqrt(j_i), then
// Adam's 1 - beta1^(i+1), its reciprocal, 1 - beta2^(i+1) and its
// reciprocal.
struct StepScalars {
  float k1, one_j, two_j, sqrt_j, b1i, inv_b1i, b2i, inv_b2i;
};

template <bool ADAM, bool BETA2_ONE>
__device__ __forceinline__ StepScalars step_scalars(const float4* __restrict__ steps,
                                                    int i) {
  const float4 a = __ldg(steps + 3 * i);
  const float4 b = __ldg(steps + 3 * i + 1);
  StepScalars st{a.y, a.z, a.w, b.x, 1.0f, 1.0f, 1.0f, 1.0f};
  if (ADAM) {
    st.b1i = b.y;
    st.inv_b1i = b.z;
    if (!BETA2_ONE) {
      st.b2i = b.w;
      st.inv_b2i = __ldg(steps + 3 * i + 2).x;
    }
  }
  return st;
}

// A thread's 16 draws of a step, kept across the matvec: the popcount of a
// popcount transform (one byte each), else the normal itself.
template <int RNG>
struct Draws {
  static constexpr bool kPacked = RNG == kPopcount16 || RNG == kPopcount32;
  unsigned packed[kPacked ? TR : 1];
  float normal[kPacked ? 1 : TR][kPacked ? 1 : TC];

  // w[st] is the element's word of stream st.
  __device__ __forceinline__ void put(int r, int jj, const unsigned* w) {
    if constexpr (kPacked) {
      const unsigned c = (unsigned)__popc(w[0]) << (8 * jj);
      packed[r] = jj ? packed[r] | c : c;
    } else {
      normal[r][jj] = normal_one<RNG>(w);
    }
  }

  // The element's standard normal, as normal_one<RNG> gives it.
  __device__ __forceinline__ float get(int r, int jj) const {
    if constexpr (kPacked)
      return (float)((int)((packed[r] >> (8 * jj)) & 0xFFu) - 16) * 0.35355339059327373f;
    else
      return normal[r][jj];
  }
};

// Each thread's own float4s in shared memory: sigma of its four rows; for
// Adam also the two moments and mu of each.  The registers hold mu (but for
// Adam), the matvec's sums and its operands: 18 warps per SM leave 96
// registers a thread (five warps to each quarter's 16,384), and Adam's
// moments and mu in registers spill.  Adam pays with one x buffer (a second
// barrier a step) for the room in shared memory.
__host__ __device__ constexpr int own_slots(bool adam) { return adam ? 4 * TR : TR; }
__host__ __device__ constexpr int x_buffers(bool adam) {
  return CCVM_X_BUFFERS ? CCVM_X_BUFFERS : adam ? 1 : 2;
}

// The launch rule (ops/build.py mf_launch_shape states the same): threads,
// trajectories a block and shared-memory bytes; non-zero when N does not
// fit.  Shared memory: Q (NP x NP), the per-column V term (and S_j and
// inv_j), the x buffers of R rows of stride NP + 4, and each thread's own
// float4s.
__host__ __device__ inline int mf_launch_shape(int n, bool adam, bool cols, int* threads,
                                               int* rows, long long* smem) {
  const int np = (n + TC - 1) / TC * TC;
  const int groups = np / TC;
  const int rgroups = groups > 0 ? (kThreads / groups < kMaxRowGroups
                                        ? kThreads / groups : kMaxRowGroups) : 0;
  *threads = groups * rgroups;
  *rows = rgroups * TR;
  *smem = 4LL * ((long long)np * np + (cols ? 3 : 1) * np +
                 (long long)x_buffers(adam) * *rows * (np + 4)) +
          16LL * own_slots(adam) * *threads;
  return (n >= 1 && rgroups >= 1 && *smem <= 232448) ? 0 : 1;
}

template <bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE, int RNG, int NP,
          bool COLS, bool SEG, bool ELEM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mf_solve_kernel(const float* __restrict__ q, const float* __restrict__ v,
                const float4* __restrict__ steps, float* __restrict__ mu_out,
                float* __restrict__ mt_out, float* __restrict__ sigma_out,
                int batch, int n, int iterations, unsigned long long seed,
                MFScalars p, const float* __restrict__ cols, Segment sg) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < sg.first_block) return;  // rows below the launch's
  constexpr int np = NP;
  constexpr int ks = np + 4;  // x row stride: spreads two row groups over banks
  constexpr int groups = np / TC;
  constexpr int kXBufs = x_buffers(ADAM);
  const int R = blockDim.x / groups * TR;
  float* qs = smem;            // (np, np), zero-padded
  float* vterm = qs + np * np;  // (np): -V (u-l) / (2S); ELEM: -V (u-l)
  float* scol = vterm + np;     // COLS: (np) S_j, then (np) inv_j; 1 beyond n
  float* xbuf = scol + (COLS ? 2 * np : 0);  // kXBufs (R, ks) buffers
  // Each thread's own float4s, (slot, thread): sigma of its four rows, then
  // Adam's first moments, second moments and mu of each row.
  float4* own = reinterpret_cast<float4*>(xbuf + kXBufs * R * ks);
  const int bd = blockDim.x;

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
  // The plain version's -V * span / (2 S), one division per column: IEEE,
  // or (COLS) div_rn by 2 S_j with inv_j / 2; ELEM keeps -V * span, the
  // dividend of each element's.
  for (int j = tid; j < np; j += blockDim.x) {
    const bool in = j < n;
    const float vs = in ? __fmul_rn(-v[(size_t)inst * n + j], p.span) : 0.0f;
    if (COLS && !ELEM) {
      const float S = in ? cols[j] : 1.0f, inv = in ? cols[n + j] : 1.0f;
      vterm[j] = div_rn(vs, __fmul_rn(2.0f, S), __fmul_rn(0.5f, inv));
      scol[j] = S;
      scol[np + j] = inv;
    } else {
      vterm[j] = ELEM ? vs : __fdiv_rn(vs, __fmul_rn(2.0f, p.S));
    }
  }
  // ELEM: row `row`'s S_ij and inv_ij at the tile's four columns, from the
  // (2, rows, NP) array.
  const size_t elem_rows = (size_t)gridDim.x * R * np;
  const auto elem4 = [&](int a, int row) {
    return __ldg(reinterpret_cast<const float4*>(cols + a * elem_rows + (size_t)row * np +
                                                 col0));
  };
#pragma unroll
  for (int s = 0; s < own_slots(ADAM); ++s)
    own[s * bd + tid] = s < TR ? make_float4(0.5f, 0.5f, 0.5f, 0.5f)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const uint2 key = seed_key(seed, inst);

  // mu of row r: in registers, or (Adam) in the thread's own float4s.
  float4 mu[ADAM ? 1 : TR];
#pragma unroll
  for (int r = 0; r < (ADAM ? 1 : TR); ++r) mu[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const auto mu_row = [&](int r) -> float4 {
    if constexpr (ADAM) return own[(3 * TR + r) * bd + tid];
    else return mu[r];
  };
  const auto set_mu_row = [&](int r, const float4& m) {
    if constexpr (ADAM) own[(3 * TR + r) * bd + tid] = m;
    else mu[r] = m;
  };
  if (SEG && sg.in[0] != nullptr) {
    // The state at step `start`: mu, sigma, m, v of the tile, zero beyond n
    // and the batch.
    const auto row4 = [&](int a, int r) {
      const int row = grow0 + r;
      float e[TC];
#pragma unroll
      for (int jj = 0; jj < TC; ++jj)
        e[jj] = row < batch && col0 + jj < n
                    ? sg.in[a][((size_t)inst * batch + row) * n + col0 + jj]
                    : 0.0f;
      return make_float4(e[0], e[1], e[2], e[3]);
    };
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      set_mu_row(r, row4(0, r));
      own[r * bd + tid] = row4(1, r);
      if (ADAM) {
        own[(TR + r) * bd + tid] = row4(2, r);
        if (!BETA2_ONE) own[(2 * TR + r) * bd + tid] = row4(3, r);
      }
    }
  }
  __syncthreads();  // Q and the V term are in place

  for (int i = 0; i < iterations; ++i) {
    float* xs = xbuf + (kXBufs == 2 ? (i & 1) : 0) * R * ks;
    const float meas = __ldg(steps + 3 * i).x;
    const bool last = i == (SEG ? sg.total - sg.start : iterations) - 1;

    // The step's draws, mt and x rows (padding columns meet zero rows of Q).
    Draws<RNG> dr;
    float4 s4 = make_float4(p.S, p.S, p.S, p.S), i4 = s4;
    if (COLS && !ELEM) {
      s4 = *reinterpret_cast<const float4*>(scol + col0);
      i4 = *reinterpret_cast<const float4*>(scol + np + col0);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (ELEM) {
        s4 = elem4(0, grow0 + r);
        i4 = elem4(1, grow0 + r);
      }
      if (NOISE) {
        constexpr int NS = streams_one_of(RNG);
        uint4 wv[NS];
#pragma unroll
        for (int st = 0; st < NS; ++st)
          wv[st] = philox4x32_10(
              make_uint4((unsigned)(SEG ? i + sg.start : i), (unsigned)(grow0 + r),
                         (unsigned)cg, (unsigned)st),
              key);
#pragma unroll
        for (int jj = 0; jj < TC; ++jj) {
          unsigned w[NS];
#pragma unroll
          for (int st = 0; st < NS; ++st) w[st] = word_of(wv[st], jj);
          dr.put(r, jj, w);
        }
      }
      const float4 mu4 = mu_row(r);
      float x[TC];
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        float mt = comp(mu4, jj);
        if (NOISE) {
          const float w_inc = div_rn(__fmul_rn(dr.get(r, jj), p.noise_scale),
                                     p.sqrt_dt, p.inv_sqrt_dt);
          mt = __fadd_rn(mt, __fmul_rn(meas, w_inc));
        }
        const float mt_c = clip(mt, COLS ? comp(s4, jj) : p.S);
        if (last) {
          const int row = grow0 + r, j = col0 + jj;
          if (row < batch && j < n)
            mt_out[((size_t)inst * batch + row) * n + j] = mt_c;
        }
        x[jj] = __fadd_rn(COLS ? div_rn(__fmul_rn(mt_c, p.span), comp(s4, jj), comp(i4, jj))
                               : div_rn(__fmul_rn(mt_c, p.span), p.S, p.inv_S),
                          p.mid);
      }
      *reinterpret_cast<float4*>(xs + (lrow0 + r) * ks + col0) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();  // the step's x rows are written (and, with two buffers,
                      // the last step's read)

    // x @ Q: one fp32 FMA chain per output over k = 0, 1, ..., the plain
    // matmul's order.
    float qx[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) qx[r][jj] = 0.0f;
#pragma unroll 3
    for (int k = 0; k < (CCVM_MATVEC ? np : 0); k += 4) {
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
            qx[r][jj] = __fmaf_rn(ak, comp(qv[kk], jj), qx[r][jj]);
        }
      }
    }
    if (kXBufs == 1) __syncthreads();  // every read of x is done

    const StepScalars st = step_scalars<ADAM, BETA2_ONE>(steps, i);
    float vt[TC];
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) vt[jj] = vterm[col0 + jj];
    if (COLS && !ELEM) {
      s4 = *reinterpret_cast<const float4*>(scol + col0);
      i4 = *reinterpret_cast<const float4*>(scol + np + col0);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (ELEM) {
        s4 = elem4(0, grow0 + r);
        i4 = elem4(1, grow0 + r);
      }
      float4 mu4 = mu_row(r), sg4 = own[r * bd + tid];
      float4 m4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v4 = m4;
      if (ADAM) {
        m4 = own[(TR + r) * bd + tid];
        if (!BETA2_ONE) v4 = own[(2 * TR + r) * bd + tid];
      }
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) {
        float& mur = jj == 0 ? mu4.x : jj == 1 ? mu4.y : jj == 2 ? mu4.z : mu4.w;
        float& sgr = jj == 0 ? sg4.x : jj == 1 ? sg4.y : jj == 2 ? sg4.z : sg4.w;
        const float m = mur, sg = sgr;
        const float mu_pow = __fmul_rn(m, m);
        // fb = (-0.25 qx) (u-l) / S + vterm; -0.25 qx and -0.25 (u-l) are
        // exact, so qx (-0.25 (u-l)) rounds as the plain version's product.
        const float S = COLS ? comp(s4, jj) : p.S, inv = COLS ? comp(i4, jj) : p.inv_S;
        const float fb = __fadd_rn(
            div_rn(__fmul_rn(qx[r][jj], p.fbspan), S, inv),
            ELEM ? div_rn(vt[jj], __fmul_rn(2.0f, S), __fmul_rn(0.5f, inv)) : vt[jj]);
        const float sd = __fsub_rn(sg, 0.5f);
        const float mu_term1 =
            __fmul_rn(__fsub_rn(st.k1, __fmul_rn(p.g_sq, mu_pow)), m);
        // 2 (k1 - 3g^2 mu^2) sigma: the doubling is exact, so it is taken
        // into k1 and 3g^2 (2 k1 - 6g^2 mu^2 rounds as twice the difference).
        const float drift_sigma = __fadd_rn(
            __fadd_rn(
                __fmul_rn(__fsub_rn(__fmul_rn(2.0f, st.k1), __fmul_rn(p.g_sq6, mu_pow)), sg),
                __fmul_rn(st.two_j, __fmul_rn(sd, sd))),
            __fadd_rn(st.one_j, __fmul_rn(p.g_sq2, mu_pow)));
        const float grad = __fmul_rn(p.fs, fb);
        float drift;
        if (ADAM) {
          float& mm = jj == 0 ? m4.x : jj == 1 ? m4.y : jj == 2 ? m4.z : m4.w;
          float& vv = jj == 0 ? v4.x : jj == 1 ? v4.y : jj == 2 ? v4.z : v4.w;
          const float eff = adam<BETA2_ONE, ADD_ASSIGN>(grad, mm, vv, st.b1i, st.inv_b1i,
                                                        st.b2i, st.inv_b2i, p);
          float mu_drift = mu_term1;
          if (NOISE) {
            const float w_inc = div_rn(__fmul_rn(dr.get(r, jj), p.noise_scale),
                                       p.sqrt_dt, p.inv_sqrt_dt);
            mu_drift = __fadd_rn(mu_drift, __fmul_rn(__fmul_rn(st.sqrt_j, sd), w_inc));
          }
          drift = __fadd_rn(eff, mu_drift);
        } else {
          drift = __fadd_rn(mu_term1, grad);
          if (NOISE) {
            const float w_inc = div_rn(__fmul_rn(dr.get(r, jj), p.noise_scale),
                                       p.sqrt_dt, p.inv_sqrt_dt);
            drift = __fadd_rn(drift, __fmul_rn(__fmul_rn(st.sqrt_j, sd), w_inc));
          }
        }
        mur = clip(__fadd_rn(m, __fmul_rn(p.dt, drift)), kSafetyBound);
        sgr = __fadd_rn(sg, __fmul_rn(p.dt, drift_sigma));
      }
      set_mu_row(r, mu4);
      own[r * bd + tid] = sg4;
      if (ADAM) {
        own[(TR + r) * bd + tid] = m4;
        if (!BETA2_ONE) own[(2 * TR + r) * bd + tid] = v4;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = grow0 + r;
    if (row >= batch) continue;
    const size_t base = ((size_t)inst * batch + row) * n;
    const float4 mu4 = mu_row(r), sg4 = own[r * bd + tid];
    float4 m4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v4 = m4;
    if (SEG && ADAM) {
      m4 = own[(TR + r) * bd + tid];
      if (!BETA2_ONE) v4 = own[(2 * TR + r) * bd + tid];
    }
#pragma unroll
    for (int jj = 0; jj < TC; ++jj) {
      const int j = col0 + jj;
      if (j < n) {
        mu_out[base + j] = comp(mu4, jj);
        sigma_out[base + j] = comp(sg4, jj);
        if (SEG && ADAM) {
          sg.out[0][base + j] = comp(m4, jj);
          sg.out[1][base + j] = comp(v4, jj);
        }
      }
    }
  }
}

// One step of a tensor-parallel MF solve (ccvm_tpu_torch/parallel/tp.py) on
// a rank's (batch, nl) shard of the state, one thread an element.  The
// matvec is not computed here: mv (batch, nl) holds the reduce-scattered
// x @ Q at the shard's rows and columns, which the engine's matmul and
// collective made from x.  The step takes mf_solve_kernel's element update
// (the same operations in the same order, scalar S), at the draws of the
// element's global row and column, stores the step's measured mu_tilde (the
// readout of the last step), then measures the next step (its own draw, its
// sqrt(1/(4 j))) and writes its matvec input x = mu_tilde_c span/S + (u+l)
// into x_out (batch, nl), the change of variables that depends on the next
// step's draw.  step < 0 writes only step 0's x, for the engine's first
// matvec.  state is (mu, sigma, mu_tilde[, m, v]), each (batch, nl),
// updated in place.
template <bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE, int RNG>
__global__ void __launch_bounds__(256)
mf_step_kernel(const float* __restrict__ mv, const float* __restrict__ v,
               const float4* __restrict__ steps, float* __restrict__ state,
               float* __restrict__ x_out, int batch, int nl, int col_base,
               int row_base, int step, int total, unsigned long long seed,
               MFScalars p) {
  const size_t count = (size_t)batch * nl;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const int j = (int)(e % nl);
  const int row = row_base + (int)(e / nl), col = col_base + j;
  // Step i's w / sqrt(dt) and measured field of mu.
  const auto w_inc = [&](int i) -> float {
    if (!NOISE) return 0.0f;
    constexpr int NS = streams_one_of(RNG);
    unsigned w[NS];
    element_words<NS>(w, i, row, col, seed);
    return div_rn(__fmul_rn(normal_one<RNG>(w), p.noise_scale), p.sqrt_dt, p.inv_sqrt_dt);
  };
  const auto measured = [&](float m, int i, float wi) -> float {
    return NOISE ? __fadd_rn(m, __fmul_rn(__ldg(steps + 3 * i).x, wi)) : m;
  };
  float mu = state[e], sg = state[count + e];
  if (step >= 0) {
    const float wi = w_inc(step);
    state[2 * count + e] = measured(mu, step, wi);
    const StepScalars st = step_scalars<ADAM, BETA2_ONE>(steps, step);
    const float vt = __fdiv_rn(__fmul_rn(-v[j], p.span), __fmul_rn(2.0f, p.S));
    const float m = mu;
    const float mu_pow = __fmul_rn(m, m);
    const float fb = __fadd_rn(div_rn(__fmul_rn(mv[e], p.fbspan), p.S, p.inv_S), vt);
    const float sd = __fsub_rn(sg, 0.5f);
    const float mu_term1 = __fmul_rn(__fsub_rn(st.k1, __fmul_rn(p.g_sq, mu_pow)), m);
    const float drift_sigma = __fadd_rn(
        __fadd_rn(
            __fmul_rn(__fsub_rn(__fmul_rn(2.0f, st.k1), __fmul_rn(p.g_sq6, mu_pow)), sg),
            __fmul_rn(st.two_j, __fmul_rn(sd, sd))),
        __fadd_rn(st.one_j, __fmul_rn(p.g_sq2, mu_pow)));
    const float grad = __fmul_rn(p.fs, fb);
    const float diffusion = __fmul_rn(__fmul_rn(st.sqrt_j, sd), wi);
    float drift;
    if (ADAM) {
      float mm = state[3 * count + e], vv = state[4 * count + e];
      const float eff =
          adam<BETA2_ONE, ADD_ASSIGN>(grad, mm, vv, st.b1i, st.inv_b1i, st.b2i, st.inv_b2i, p);
      drift = __fadd_rn(eff, NOISE ? __fadd_rn(mu_term1, diffusion) : mu_term1);
      state[3 * count + e] = mm;
      state[4 * count + e] = vv;
    } else {
      drift = __fadd_rn(mu_term1, grad);
      if (NOISE) drift = __fadd_rn(drift, diffusion);
    }
    mu = clip(__fadd_rn(m, __fmul_rn(p.dt, drift)), kSafetyBound);
    sg = __fadd_rn(sg, __fmul_rn(p.dt, drift_sigma));
    state[e] = mu;
    state[count + e] = sg;
  }
  const int next = step + 1;
  if (next < total) {
    const float mt_c = clip(measured(mu, next, w_inc(next)), p.S);
    x_out[e] = __fadd_rn(div_rn(__fmul_rn(mt_c, p.span), p.S, p.inv_S), p.mid);
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

auto const kStep = &mf_step_kernel<CCVM_ADAM != 0, CCVM_BETA2_ONE != 0,
                                   CCVM_ADD_ASSIGN != 0, CCVM_NOISE != 0, CCVM_RNG>;

}  // namespace

extern "C" {

// One step of a tensor-parallel solve (mf_step_kernel): mv (batch, nl)
// (unread when step < 0), v (nl) the shard's V, steps the whole solve's
// (total, 12) table, state (3 or 5, batch, nl) updated in place, x_out
// (batch, nl) (unwritten by the last step): float32, contiguous, on the
// device.  The shard's row 0 and column 0 are the global row_base and
// col_base.  scalars: 24 host floats in MFScalars order.  Launches on
// `stream`, does not synchronise, and returns the cudaError_t of the launch.
int ccvm_mf_step(const float* mv, const float* v, const float* steps, float* state,
                 float* x_out, int batch, int nl, int col_base, int row_base, int step,
                 int total, unsigned long long seed, const float* scalars,
                 void* stream) {
  MFScalars p;
  memcpy(&p, scalars, sizeof(MFScalars));
  if (batch < 1 || nl < 1 || step >= total || (step >= 0 && mv == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)batch * nl;
  kStep<<<(unsigned)((count + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      mv, v, reinterpret_cast<const float4*>(steps), state, x_out, batch, nl, col_base,
      row_base, step, total, seed, p);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else

namespace {

constexpr bool kAdam = CCVM_ADAM != 0;
constexpr bool kCols = CCVM_COLS != 0;
constexpr bool kSeg = CCVM_SEG != 0;
constexpr bool kElem = CCVM_ELEM != 0;
static_assert(CCVM_NP % TC == 0 && CCVM_NP >= TC, "NP: N padded to a multiple of 4");
static_assert(!kElem || kCols, "a per-element S is a build of the per-column one");
auto const kKernel = &mf_solve_kernel<kAdam, CCVM_BETA2_ONE != 0, CCVM_ADD_ASSIGN != 0,
                                      CCVM_NOISE != 0, CCVM_RNG, CCVM_NP, kCols, kSeg,
                                      kElem>;

// mf_launch_shape for this build's problem size class.
int launch_shape(int n, int* threads, int* rows, long long* smem) {
  if ((n + TC - 1) / TC * TC != CCVM_NP) return 1;
  return mf_launch_shape(n, kAdam, kCols, threads, rows, smem);
}

}  // namespace

extern "C" {

// q (I, n, n), v (I, n), steps (total, 12), mu_out / mt_out / sigma_out
// (I, batch, n): float32, contiguous, on the device; mt_out is written by
// the solve's last step only (left as it is when iterations is 0, or by a
// segment that ends earlier).  scalars: 24 host floats in MFScalars order.
// cols: the (2, n) S_j and inv_j of a CCVM_COLS build, the (2, rows, NP)
// S_ij and inv_ij of a CCVM_ELEM one (rows: the batch padded to whole
// blocks), else unused.  seg: a host Segment
// of a CCVM_SEG build (state in mu, sigma, m, v; moments out m, v), else
// nullptr.  row_base: the global row of trajectory 0 (a data-parallel
// rank's first row; a multiple of the block's rows, and one instance): the
// outputs and seg's arrays hold its rows only, and a CCVM_ELEM cols array
// has row_base leading rows (ccvm_common.cuh Segment).  Launches on
// `stream`, does not synchronise, and returns the
// cudaError_t of the launch.
int ccvm_mf_solve(const float* q, const float* v, const float* steps,
                  float* mu_out, float* mt_out, float* sigma_out,
                  int num_instances, int batch, int n, int iterations,
                  unsigned long long seed, const float* scalars,
                  int rows_per_block, void* stream, const float* cols,
                  const void* seg, int row_base) {
  MFScalars p;
  memcpy(&p, scalars, sizeof(MFScalars));
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
  mu_out = shifted(mu_out, row_base, n);
  mt_out = shifted(mt_out, row_base, n);
  sigma_out = shifted(sigma_out, row_base, n);
  batch += row_base;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows - 1) / rows, num_instances);
  kKernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, reinterpret_cast<const float4*>(steps + 12 * (size_t)sg.start), mu_out, mt_out,
      sigma_out, batch, n, iterations, seed, p, cols, sg);
  return (int)cudaGetLastError();
}

// Blocks of this specialisation the card keeps resident per SM at problem
// size n (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns a
// cudaError_t.
int ccvm_mf_blocks_per_sm(int n, int* blocks) {
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
