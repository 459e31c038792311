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
// What bounds it on this card: operations.  The two matvecs are 4*B*N^2*T
// flops, the rest ~40*B*N*T (DL-Adam ~64) and one Philox call per 4 elements
// per step; Q and the state never leave the chip, so the bytes are
// negligible.  At B=65536, N=70, T=15000 the matvecs are 1.93e13 flops:
//   * on the fp32 CUDA cores (66.9 TFLOP/s) the least time is 329.1 ms
//     (DL-Adam 353.8 ms);
//   * as 3xTF32 on the tensor cores (three TF32 products per fp32 product
//     at 495 TFLOP/s) the matvecs take 116.8 ms, and the elementwise work on
//     the CUDA cores 41.1 ms (DL-Adam 65.8 ms).  The two pipes issue side
//     by side (an mma.sync takes one issue slot of several cycles of tensor
//     work), so the least time is the longer, 116.8 ms for both kernels;
//     157.9 and 182.6 ms, the sums, hold only if nothing overlapped.
//
// The template has two matvecs (MMA, chosen at build time):
//
// MMA = 1, the tensor-core design that ops/dl_kernels.py launches:
//   * one warp owns 8 trajectories for ALL iterations.  Its m16n8k8 tile
//     stacks them: rows 0-7 are their c, rows 8-15 their s, so each Q
//     fragment feeds both matvecs.  Lane (g = lane/4, t = lane%4) holds
//     columns 8j+2t and 8j+2t+1 of trajectory g for every n-tile j, in the
//     mma accumulator layout;
//   * the accumulator layout doubles as the A layout: A's k slots t and t+4
//     are taken to be columns 2t and 2t+1 of the k-tile, and Q's rows are
//     permuted to match once per block, so x is built from the lane's own
//     c and s and never goes through shared memory;
//   * 3xTF32: Q is split once per block into hi = rna(q) and lo = rna(q-hi),
//     stored in fragment order ((hi, hi, lo, lo) per lane: one 16-byte load
//     per fragment, conflict-free); x is split the same way on the fly; each
//     product is lo*hi + hi*lo + hi*hi, accumulated in fp32;
//   * the tensor cores' fp32 accumulation truncates, so the error grows with
//     the sums' size: the mma takes x centred, z*span/S_d, and the box
//     midpoint's share, (u+l) times Q's column sums, is added once per block
//     in fp32 (with uncentred x DL-Adam missed its 1e-4 hold over 1,000
//     steps at the main shape);
//   * the accumulators (36 registers at N=70) hold the registers: DL keeps c
//     and s in shared memory, where each lane reads and writes only its own
//     float4s; DL-Adam keeps its four moment arrays there, c and s of its
//     first four n-tiles in registers and the rest in shared memory (all in
//     shared memory would need 263 KB).  So no main-path specialisation
//     spills at the 128-register bound;
//   * warps share only the read-only Q fragments, so the block synchronises
//     once, after loading Q, and never inside the step loop;
//   * DL: 8 warps (64 trajectories) per block, two blocks per SM.  DL-Adam:
//     16 warps (128 trajectories), one block per SM.  Either way 16 warps per
//     SM; at batch 65536, N=70 the grids are 1,024 and 512 blocks, 3.88 waves
//     of the 132 SMs;
//   * noise: a lane pair (t, t^1) shares each Philox call of a row's four
//     columns; each lane draws one call per two n-tiles and hands the other
//     lane its two words with a shuffle.
// MMA = 0, the CUDA-core design, kept as a race row (launched only by the
//   race harness, ccvm_tpu_torch/tools/kernel_experiments.py): a thread
//   owns a 4-row x 4-column tile of c and s (and of the four Adam moments)
//   in registers and computes both matvecs with fp32 FMAs, reading float4s
//   of x (rebuilt in shared memory each step, two block barriers a step)
//   and Q.
//
// Both designs take every division of a per-step constant out of the
// element loop.  span/S_d and 0.25*span/S_d are taken once per solve, on the
// host (so S_d, and with it the pump > 1 choice, is a parameter).  The
// schedules, sqrt(dt)*nr_i, sqrt(dt)/nr_i (with noise_scale) and
// 1/(1-beta^(i+1)) come from a per-step table that the wrapper fills.  Per
// element only Adam's mhat/(sqrt(vhat)+eps) divides, and it and the square
// roots take the hardware's approximations.  So the kernel differs from the
// plain version (which keeps the JAX package's order of operations) by
// round-off only.
//
// Noise is a stateless Philox4x32-10: key = seed + instance, counter =
// (step, trajectory row, column/4, stream), word = column % 4.  Draws do not
// depend on the block shape or the design, and ops/philox.py reproduces
// them; the grid is (blocks, instances), blockIdx.y the instance.
// Later work: wgmma (64-row warpgroup tiles whose Q fragments the tensor
// cores read from shared memory, four warps to each load where mma.sync
// loads Q once per warp), and a persistent schedule if the last wave's 12%
// idle share comes to matter.
//
// Philox, the Wiener transforms, the clip and the CUDA-core launch shape are
// shared with the other kernels through ccvm_common.cuh.  Specialisations
// (the template parameters) are chosen at build time with -D flags by
// ccvm_tpu_torch/ops/build.py; each build exports ccvm_dl_solve and
// ccvm_dl_blocks_per_sm.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"

namespace {

using namespace ccvm;

constexpr float kSafetyBound = 1.0e3f;  // _DL_SAFETY_BOUND

// The solve's scalars, and its per-solve constants taken once on the host in
// float32 (ops/dl_kernels.py _scalars): S_d, span/S_d, u+l, 0.25*span/S_d
// and 2g.  Kernel parameters live in the constant bank, so they cost the
// step loop no registers.
struct DLScalars {
  float pump, S, dt, noise_ratio, fs, g, lo, hi, T;
  float alpha, beta1, one_minus_beta1, beta2, one_minus_beta2;
  float noise_scale;
  float S_d, xscale, mid, fbscale, two_g;
};
static_assert(sizeof(DLScalars) == 20 * sizeof(float), "DLScalars layout");

// Launch bounds: the tensor-core design takes up to 8 warps a block at two
// blocks per SM (DL), or 16 at one (DL-Adam); either way <= 128 registers.
// The CUDA-core design takes up to 256 threads, two blocks per SM for DL and
// one for DL-Adam.
template <bool MMA, bool ADAM>
struct Bounds {
  static constexpr int kThreads = MMA ? (ADAM ? 512 : 256) : kMaxThreads;
  static constexpr int kBlocks = ADAM ? 1 : 2;
};

// The step's scalars, from the table the wrapper fills on the device in
// float32 with the plain version's own operations (ops/dl_kernels.py
// _step_table), 8 floats a step: fs(0.5+rate), pump*rate,
// noise_scale*sqrt(dt)*nr_i, noise_scale*sqrt(dt)/nr_i, and DL-Adam's
// 1/(1-beta1^(i+1)), 1/(1-beta2^(i+1)).  So no schedule, exp, pow or
// division of a per-step constant is evaluated in the kernel.
struct StepScalars {
  float fs_dyn, pr, kc, ks, inv_b1i, inv_b2i;
};

template <bool ADAM>
__device__ __forceinline__ StepScalars step_scalars(const float4* __restrict__ steps,
                                                    int i) {
  const float4 a = __ldg(steps + 2 * i);
  StepScalars st{a.x, a.y, a.z, a.w, 1.0f, 1.0f};
  if (ADAM) {
    const float4 b = __ldg(steps + 2 * i + 1);
    st.inv_b1i = b.x;
    st.inv_b2i = b.y;
  }
  return st;
}

// The element loop's square roots and Adam's one division use the hardware
// approximations (MUFU: sqrt.approx.f32 and __fdividef, a few ulp), not the
// IEEE sequences with their fix-up branches, which would take a large share
// of DL-Adam's element loop; the holds against the plain version bound the
// difference.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Adam filtering of one gradient element with the step's reciprocal bias
// corrections (the update of ccvm_common.cuh's adam(), without its two
// per-element divisions by a per-step constant).
template <bool BETA2_ONE, bool ADD_ASSIGN>
__device__ __forceinline__ float adam_filter(float grad, float& m, float& v,
                                             const StepScalars& st,
                                             const DLScalars& p) {
  m = p.beta1 * m + p.one_minus_beta1 * grad;
  const float mhat = m * st.inv_b1i;
  float update;
  if (BETA2_ONE) {
    update = p.alpha * mhat;
  } else {
    v = p.beta2 * v + p.one_minus_beta2 * (grad * grad);
    const float vhat = v * st.inv_b2i;
    update = __fdividef(p.alpha * mhat, sqrt_approx(vhat) + 1e-8f);
  }
  return ADD_ASSIGN ? grad + update : update;
}

// One Euler-Maruyama step of one (c, s) element from its two matvec sums.
template <bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE>
__device__ __forceinline__ void element_step(
    float& c, float& s, float fbg_c, float fbg_s, float z1, float z2,
    float& mc, float& vc, float& ms, float& vs, const StepScalars& st,
    const DLScalars& p) {
  const float cv = c, sv = s;
  const float c_pow = cv * cv;
  const float s_pow = sv * sv;
  float c_drift, s_drift;
  if (ADAM) {
    const float gc = adam_filter<BETA2_ONE, ADD_ASSIGN>(-fbg_c, mc, vc, st, p);
    const float gs = adam_filter<BETA2_ONE, ADD_ASSIGN>(-fbg_s, ms, vs, st, p);
    c_drift = ((-1.0f + st.pr - c_pow - s_pow) * cv) + gc;
    s_drift = ((-1.0f - st.pr - c_pow - s_pow) * sv) + gs;
  } else {
    c_drift = -st.fs_dyn * fbg_c + (-1.0f + st.pr - c_pow - s_pow) * cv;
    s_drift = -st.fs_dyn * fbg_s + (-1.0f - st.pr - c_pow - s_pow) * sv;
  }
  float cn = cv + p.dt * c_drift;
  float sn = sv + p.dt * s_drift;
  if (NOISE) {
    const float diff = p.two_g * sqrt_approx(c_pow + s_pow + 0.5f);
    cn = cn + diff * (z1 * st.kc);
    sn = sn + diff * (z2 * st.ks);
  }
  c = clip(cn, kSafetyBound);
  s = clip(sn, kSafetyBound);
}

// ---------------------------------------------------------------- MMA = 1

// x rounded to TF32 (low 13 bits zero) to nearest with ties away, as
// cvt.rna.tf32.f32 rounds a finite x: half a unit added to the magnitude's
// bits, then truncated.  Two integer instructions; the cvt's own sequence
// also screens Inf and NaN, which Q and the clipped state never hold.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// d += a (16x8, row-major) * b (8x8, column-major), TF32 in, fp32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// n-tiles of c and s that a lane keeps in registers: none for DL; for
// DL-Adam the first four, the rest in shared memory beside its moments (at
// N=70 all of c, s and the moments in shared memory would need 263 KB for 16
// warps, and all of c and s in registers spill).
__host__ __device__ constexpr int reg_state_tiles(int nt, bool adam) {
  return adam ? (nt < 4 ? nt : 4) : 0;
}

// Each lane's own float4s in shared memory: its c and s beyond the register
// tiles, then DL-Adam's two moments (2 nt).
__host__ __device__ constexpr int own_float4s(int nt, bool adam) {
  return nt - reg_state_tiles(nt, adam) + (adam ? 2 * nt : 0);
}

// Shared-memory floats of the tensor-core block: Q's fragments (hi, hi, lo,
// lo per lane), the per-column offsets, and each lane's own float4s.
__host__ __device__ constexpr long long mma_smem_floats(int nt, int warps,
                                                        bool adam) {
  return 4LL * nt * nt * 32 + 8LL * nt + 4LL * own_float4s(nt, adam) * 32 * warps;
}

// The lane's trajectory row and its lane id, from the ids read anew: values
// the compiler cannot carry across the step loop, where they would spill.
__device__ __forceinline__ unsigned lane_row(unsigned& ln) {
  unsigned tx, bx;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(ln));
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tx));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  return bx * (blockDim.x / 4) + (tx >> 5) * 8 + (ln >> 2);
}

// acc[j] = (x_c @ Q, x_s @ Q) at the lane's columns of n-tile j: k-tile kt's
// A fragments are built from the lane's state z_of(kt) (its own
// accumulator-layout tile), split into TF32 hi and lo; each Q fragment is one
// 16-byte load (hi, hi, lo, lo).
template <int NT, class ZOf>
__device__ __forceinline__ void matvec(float (&acc)[NT][4],
                                       const float4* __restrict__ qf, int lane,
                                       const DLScalars& p, const ZOf& z_of) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    const float4 z = z_of(kt);
    const float x[4] = {z.x * p.xscale, z.z * p.xscale, z.y * p.xscale, z.w * p.xscale};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float hi = tf32_round(x[r]);
      ah[r] = __float_as_uint(hi);
      al[r] = __float_as_uint(tf32_round(x[r] - hi));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b = qf[(kt * NT + nt) * 32 + lane];
      mma_tf32(acc[nt], al, b.x, b.y);
      mma_tf32(acc[nt], ah, b.z, b.w);
      mma_tf32(acc[nt], ah, b.x, b.y);
    }
  }
}

template <bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE, int RNG,
          int NT>
__device__ __forceinline__ void dl_mma_body(
    const float* __restrict__ q, const float* __restrict__ v,
    const float4* __restrict__ steps, float* __restrict__ c_out,
    float* __restrict__ s_out, int batch, int n, int iterations,
    unsigned long long seed, const DLScalars& p, float* smem) {
  constexpr int NP = 8 * NT;
  float4* qf = reinterpret_cast<float4*>(smem);  // (k-tile, n-tile, lane)
  float* offs = smem + 4 * NT * NT * 32;         // (NP)
  float4* own = reinterpret_cast<float4*>(offs + NP);  // (warp, own_float4s, lane)

  const int inst = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int odd = lane & 1;
  const int row0 = blockIdx.x * (blockDim.x / 4) + warp * 8;  // 8 per warp

  // Q's B fragments with k permuted: slot t is row 8kt+2t, slot t+4 row
  // 8kt+2t+1; zero-padded to NP x NP.
  const float* qi = q + (size_t)inst * n * n;
  for (int e = tid; e < NT * NT * 32; e += blockDim.x) {
    const int L = e & 31, f = e >> 5;
    const int k0 = 8 * (f / NT) + 2 * (L & 3), col = 8 * (f % NT) + (L >> 2);
    const float b0 = (k0 < n && col < n) ? qi[k0 * n + col] : 0.0f;
    const float b1 = (k0 + 1 < n && col < n) ? qi[(k0 + 1) * n + col] : 0.0f;
    const float h0 = tf32_round(b0), h1 = tf32_round(b1);
    qf[e] = make_float4(h0, h1, tf32_round(b0 - h0), tf32_round(b1 - h1));
  }
  // x = z*span/S_d + (u+l) splits x @ Q into (z*span/S_d) @ Q, on the tensor
  // cores, and (u+l) * (column sums of Q), once per block in fp32: the mma
  // accumulates the centred part only, whose smaller sums lose less to its
  // fp32 accumulation (which truncates).  offs[j] = 0.25*span/S_d times that
  // column term, plus g3 = V*span/(2 S_d).
  for (int j = tid; j < NP; j += blockDim.x) {
    float colsum = 0.0f;
    for (int k = 0; k < n && j < n; ++k) colsum += qi[k * n + j];
    offs[j] = j < n ? p.fbscale * (p.mid * colsum) +
                          v[(size_t)inst * n + j] * (p.hi - p.lo) / (2.0f * p.S_d)
                    : 0.0f;
  }
  __syncthreads();  // the block's only barrier
  if (row0 >= batch) return;  // whole warps only: no later barrier

  // The state of n-tile j, z = (c h=0, c h=1, s h=0, s h=1) at columns
  // 8j+2t+h: in registers (zr) for the first kReg n-tiles, else in shared
  // memory at my[(j-kReg)*32], where each lane reads and writes only its own
  // float4s (16-byte accesses of consecutive lanes, conflict-free); so the
  // accumulators hold the registers.  DL-Adam's moments of n-tile j follow:
  // first at my[(kMom+j)*32], second at my[(kMom+NT+j)*32].
  constexpr int kReg = reg_state_tiles(NT, ADAM);
  constexpr int kMom = NT - kReg;
  constexpr int kOwn = own_float4s(NT, ADAM);
  float4* my = own + (size_t)warp * kOwn * 32 + lane;
  float4 zr[kReg > 0 ? kReg : 1];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) my[e * 32] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < kReg; ++j) zr[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const auto z_of = [&](int j) -> float4 { return j < kReg ? zr[j] : my[(j - kReg) * 32]; };
  const auto set_z = [&](int j, const float4& z) {
    if (j < kReg) zr[j] = z; else my[(j - kReg) * 32] = z;
  };
  const uint2 key = seed_key(seed, inst);

  for (int i = 0; i < iterations; ++i) {
    float acc[NT][4];
    matvec<NT>(acc, qf, lane, p, z_of);
    const StepScalars st = step_scalars<ADAM>(steps, i);

    constexpr int NS = streams_of(RNG);
    // The counter's row and column words (cg0 + 4pp for tile pair pp) are
    // the same every step; taken from the ids read anew each step, so that
    // the compiler does not hold them (and their first-round Philox
    // products) across the step loop.
    unsigned ln;
    const unsigned row_i = lane_row(ln);
    const unsigned cg0 = 2 * (ln & 1) + ((ln >> 1) & 1);
#pragma unroll
    for (int pp = 0; pp < (NT + 1) / 2; ++pp) {
      // Words of columns 8j+2t+h for j = 2pp (wa) and 2pp+1 (wb): the even
      // lane of a pair draws tile 2pp, the odd lane tile 2pp+1, and each
      // hands the other the two words of its partner's columns.
      unsigned wa[NS][2], wb[NS][2];
      if (NOISE) {
        const unsigned cg = cg0 + 4 * pp;  // = 2 (2pp + odd) + t/2
#pragma unroll
        for (int sidx = 0; sidx < NS; ++sidx) {
          const uint4 w = philox4x32_10(
              make_uint4((unsigned)i, row_i, cg, (unsigned)sidx), key);
          const unsigned own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
          const unsigned r0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? w.x : w.z, 1);
          const unsigned r1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? w.y : w.w, 1);
          wa[sidx][0] = odd ? r0 : own0;
          wa[sidx][1] = odd ? r1 : own1;
          wb[sidx][0] = odd ? own0 : r0;
          wb[sidx][1] = odd ? own1 : r1;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * pp + jj;
        if (j >= NT) continue;
        // Adam's moments of n-tile j in the accumulator layout: (c h=0,
        // c h=1, s h=0, s h=1), first moments then second.
        float4 z = z_of(j), m4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v4 = m4;
        if (ADAM) {
          m4 = my[(kMom + j) * 32];
          if (!BETA2_ONE) v4 = my[(kMom + NT + j) * 32];
        }
        const float2 off = *reinterpret_cast<const float2*>(offs + 8 * j + 2 * (ln & 3));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float z1 = 0.0f, z2 = 0.0f;
          if (NOISE) {
            unsigned w[NS];
#pragma unroll
            for (int sidx = 0; sidx < NS; ++sidx) w[sidx] = jj ? wb[sidx][h] : wa[sidx][h];
            normal_pair<RNG>(w, z1, z2);
          }
          element_step<ADAM, BETA2_ONE, ADD_ASSIGN, NOISE>(
              h ? z.y : z.x, h ? z.w : z.z,
              fmaf(acc[j][h], p.fbscale, h ? off.y : off.x),
              fmaf(acc[j][2 + h], p.fbscale, h ? off.y : off.x), z1, z2,
              h ? m4.y : m4.x, h ? v4.y : v4.x, h ? m4.w : m4.z, h ? v4.w : v4.z,
              st, p);
        }
        set_z(j, z);
        if (ADAM) {
          my[(kMom + j) * 32] = m4;
          if (!BETA2_ONE) my[(kMom + NT + j) * 32] = v4;
        }
      }
    }
  }

  unsigned ln;
  const int row = (int)lane_row(ln);
  if (row >= batch) return;
  const size_t base = ((size_t)inst * batch + row) * n;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 z = z_of(j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * j + 2 * (ln & 3) + h;
      if (col < n) {
        c_out[base + col] = clip(h ? z.y : z.x, p.S);
        s_out[base + col] = h ? z.w : z.z;
      }
    }
  }
}

// ---------------------------------------------------------------- MMA = 0

template <bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN, bool NOISE, int RNG>
__device__ __forceinline__ void dl_core_body(
    const float* __restrict__ q, const float* __restrict__ v,
    const float4* __restrict__ steps, float* __restrict__ c_out,
    float* __restrict__ s_out, int batch, int n, int iterations,
    unsigned long long seed, const DLScalars& p, float* smem) {
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
    const int kk = e / np, j = e % np;
    qs[e] = (kk < n && j < n) ? qi[kk * n + j] : 0.0f;
  }

  float g3[TC];
#pragma unroll
  for (int jj = 0; jj < TC; ++jj) {
    const int j = col0 + jj;
    g3[jj] = j < n ? v[(size_t)inst * n + j] * (p.hi - p.lo) / (2.0f * p.S_d) : 0.0f;
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
      a.x = c[r][0] * p.xscale + p.mid;
      a.y = c[r][1] * p.xscale + p.mid;
      a.z = c[r][2] * p.xscale + p.mid;
      a.w = c[r][3] * p.xscale + p.mid;
      b.x = s[r][0] * p.xscale + p.mid;
      b.y = s[r][1] * p.xscale + p.mid;
      b.z = s[r][2] * p.xscale + p.mid;
      b.w = s[r][3] * p.xscale + p.mid;
      *reinterpret_cast<float4*>(xc + (lrow0 + r) * ks + col0) = a;
      *reinterpret_cast<float4*>(xs + (lrow0 + r) * ks + col0) = b;
    }
    __syncthreads();

    float qc[TR][TC], qsum[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int jj = 0; jj < TC; ++jj) qc[r][jj] = qsum[r][jj] = 0.0f;
    for (int kk = 0; kk < np; kk += 4) {
      float4 qv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        qv[u] = *reinterpret_cast<const float4*>(qs + (kk + u) * np + col0);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(xc + (lrow0 + r) * ks + kk);
        const float4 b = *reinterpret_cast<const float4*>(xs + (lrow0 + r) * ks + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float ak = comp(a, u), bk = comp(b, u);
#pragma unroll
          for (int jj = 0; jj < TC; ++jj) {
            qc[r][jj] = fmaf(ak, comp(qv[u], jj), qc[r][jj]);
            qsum[r][jj] = fmaf(bk, comp(qv[u], jj), qsum[r][jj]);
          }
        }
      }
    }
    __syncthreads();  // every read of x is done before the next step writes

    const StepScalars st = step_scalars<ADAM>(steps, i);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float z1[TC], z2[TC];
      if (NOISE) {
        constexpr int NS = streams_of(RNG);
        uint4 wv[NS];
#pragma unroll
        for (int sidx = 0; sidx < NS; ++sidx)
          wv[sidx] = philox4x32_10(
              make_uint4((unsigned)i, (unsigned)(grow0 + r), (unsigned)cg,
                         (unsigned)sidx),
              key);
#pragma unroll
        for (int jj = 0; jj < TC; ++jj) {
          unsigned w[NS];
#pragma unroll
          for (int sidx = 0; sidx < NS; ++sidx) w[sidx] = word_of(wv[sidx], jj);
          normal_pair<RNG>(w, z1[jj], z2[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < TC; ++jj)
        element_step<ADAM, BETA2_ONE, ADD_ASSIGN, NOISE>(
            c[r][jj], s[r][jj], qc[r][jj] * p.fbscale + g3[jj],
            qsum[r][jj] * p.fbscale + g3[jj],
            NOISE ? z1[jj] : 0.0f, NOISE ? z2[jj] : 0.0f, mc[r][jj], vc[r][jj],
            ms[r][jj], vs[r][jj], st, p);
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

template <bool MMA, int NT, bool ADAM, bool BETA2_ONE, bool ADD_ASSIGN,
          bool NOISE, int RNG>
__global__ void __launch_bounds__(Bounds<MMA, ADAM>::kThreads,
                                  Bounds<MMA, ADAM>::kBlocks)
dl_solve_kernel(const float* __restrict__ q, const float* __restrict__ v,
                const float4* __restrict__ steps, float* __restrict__ c_out,
                float* __restrict__ s_out, int batch, int n, int iterations,
                unsigned long long seed, DLScalars p) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (MMA)
    dl_mma_body<ADAM, BETA2_ONE, ADD_ASSIGN, NOISE, RNG, NT>(
        q, v, steps, c_out, s_out, batch, n, iterations, seed, p, smem);
  else
    dl_core_body<ADAM, BETA2_ONE, ADD_ASSIGN, NOISE, RNG>(
        q, v, steps, c_out, s_out, batch, n, iterations, seed, p, smem);
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
#define CCVM_RNG 1
#endif
#ifndef CCVM_MMA
#define CCVM_MMA 1
#endif
#ifndef CCVM_NT
#define CCVM_NT 9
#endif

namespace {

constexpr bool kMma = CCVM_MMA != 0;
constexpr bool kAdam = CCVM_ADAM != 0;
static_assert(!kMma || (CCVM_NT >= 1 && CCVM_NT <= 16), "NT: 1 to 16 n-tiles");

auto const kKernel =
    &dl_solve_kernel<kMma, (kMma ? CCVM_NT : 1), kAdam, CCVM_BETA2_ONE != 0,
                     CCVM_ADD_ASSIGN != 0,
                     CCVM_NOISE != 0, CCVM_RNG>;

// Threads and shared-memory bytes of a launch (ops/build.py
// dl_launch_shape states the same rule); non-zero when this build does not
// take n or the block does not fit.
int dl_launch_shape(int n, int rows_per_block, int* threads, long long* smem) {
  if (!kMma) return ccvm::launch_shape(n, rows_per_block, 2, threads, smem);
  if ((n + 7) / 8 != CCVM_NT || n < 1 || rows_per_block % 8 != 0) return 1;
  const int warps = rows_per_block / 8;
  *threads = 32 * warps;
  *smem = 4LL * mma_smem_floats(CCVM_NT, warps, kAdam);
  return (warps >= 1 && *threads <= Bounds<true, kAdam>::kThreads) ? 0 : 1;
}

}  // namespace

extern "C" {

// q (I, n, n), v (I, n), steps (iterations, 8), c_out / s_out (I, batch, n):
// float32, contiguous, on the device.  scalars: 20 host floats in DLScalars
// order.  Launches on `stream`, does not synchronise, and returns the
// cudaError_t of the launch.
int ccvm_dl_solve(const float* q, const float* v, const float* steps,
                  float* c_out, float* s_out, int num_instances, int batch,
                  int n, int iterations,
                  unsigned long long seed, const float* scalars,
                  int rows_per_block, void* stream) {
  DLScalars p;
  memcpy(&p, scalars, sizeof(DLScalars));
  int threads;
  long long smem;
  if (dl_launch_shape(n, rows_per_block, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, num_instances);
  kKernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, reinterpret_cast<const float4*>(steps), c_out, s_out, batch, n,
      iterations, seed, p);
  return (int)cudaGetLastError();
}

// Blocks of this specialisation the card keeps resident per SM at problem
// size n and rows_per_block (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// returns a cudaError_t.
int ccvm_dl_blocks_per_sm(int n, int rows_per_block, int* blocks) {
  int threads;
  long long smem;
  if (dl_launch_shape(n, rows_per_block, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kKernel, threads, (size_t)smem);
}

}  // extern "C"
