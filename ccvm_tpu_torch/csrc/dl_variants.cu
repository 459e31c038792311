// Whole-solve kernels of the DL race harness for Hopper (sm_90a): the two
// variants of the DL-CCVM step that are raced against the production kernel
// (dl_solve.cu), on the production kernel's tensor-core design.
//
// Replaces the Pallas TPU kernels `_dl_kernel_v2` and `_dl_kernel_v3`
// (tools/kernel_experiments.py:91 and :201).  Both integrate the DL-CCVM SDE
// of dl_solve.cu with no per-step safety clip, the pump rate always (i+1)/T
// and the drift saturation always S_d = sqrt(pump-1).  With span = u-l,
// mid = u+l, g3 = V*span/(2 S_d), nr_i = (nr-1) e^{-3(i+1)/T} + 1 and
// diff = 2g sqrt(c^2+s^2+0.5), a step is, for z in {c, s}:
//
//   v2: x = z*(span/S_d) + mid;  fb_z = 0.25 * (x @ Q) * (span/S_d)
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
// What bounds it on this card: operations, as dl_solve.cu.  The two matvecs
// are 4*B*N^2 flop a step, as 3xTF32 on the tensor cores 116.8 ms at
// B=65536, N=70, 15,000 steps; beside them ~42 (v2) or 34 (v3) flop an
// element a step on the CUDA cores and the Philox calls.
//
// The design is dl_solve.cu's tensor-core one, through ccvm_mma.cuh: Q split
// once per block into TF32 hi and lo in fragment order, x split on the fly,
// each product lo*hi + hi*lo + hi*hi in one truncating fp32 chain of
// m16n8k8 mma.sync; the A fragment built from the lane's own state; a
// block synchronises after loading Q and otherwise only between unrolled
// steps of FUSE 1 (below); c and s in shared memory,
// each lane reading and writing only its own float4s, where the
// accumulators need the registers.  Either layout (FUSE below) keeps 64
// trajectories a block and two blocks, 128 trajectories, on an SM, as the
// production DL kernel does:
//   * FUSE 1, 8 trajectories a warp, 8 warps a block, at the 128-register
//     cap, as production;
//   * FUSE 0, 16 a warp, 4 warps a block, at up to 255 registers: its two
//     accumulator tiles take 72 at N=70, and 8 warps a block at the
//     128-register cap spilled kilobytes; the two passes and the two rows of
//     the element step are rolled loops, one copy of their code each.
// Unrolled steps (UNROLL > 1) multiply the step's code beyond what the
// instruction cache holds at 8 steps (the race's "unroll 8 against 1" knobs
// measure the cost): two blocks an SM, two streams of instructions, ran
// FUSE 0's unroll 8 faster than one 8-warp block did, and with FUSE 1 a
// block barrier between unrolled steps, which keeps the block's warps on
// the same lines, helped (with FUSE 0 it did not).
//
// The A operand: v3 takes c and s themselves (centred by construction); v2
// x as written, not centred as dl_solve.cu centres it:
// ccvm_tpu_torch/tools/tc_model.py --family variants models this chain and
// holds x as written within 1e-4 of the fp32 plain version (about twice the
// centred scheme's difference), so v2 keeps the TPU kernel's x and the v3
// knob measures the whole change of variables.
//
// Knobs, as template parameters chosen with -D flags by ops/build.py
// DLVariantSpec (one library each, exporting ccvm_dl_variant):
//   V3      the v3 step above, else v2;
//   FUSE    1: production's stacking, a warp owns 8 trajectories, rows 0-7
//           of its m16 tile their x of c and rows 8-15 their x of s, so each
//           Q fragment feeds both matvecs (8 warps, 64 trajectories, a
//           block); 0: a
//           warp owns 16 trajectories, their c in one m16 tile and their s in
//           another, in two passes over Q's fragments, each loaded twice a
//           step (4 warps, 64 trajectories, a block).  On the TPU the knob
//           stacked c and s rows into one MXU call;
//   UNROLL  steps per outer iteration, fully unrolled; a tail loop covers
//           iterations % UNROLL (v2's wrapper requires 0, as the TPU kernel
//           asserts);
//   NOISE   0 elides the generator (the noise-off parity mode);
//   RNG     index into ops/philox.py HARNESS_RNG_NAMES: 0 popcount1 (the
//           popcount32 pair, 2 Philox streams per element), 1 popcount2
//           (4 streams), 2 popcount3(prod) (the popcount pair, 6 streams);
//   NT      n-tiles of 8 columns, ceil(N/8).
//
// The per-step scalars come from a (iterations, 4) table that the wrapper
// fills with the plain version's own float32 operations
// (ops/dl_variant_kernels.py _step_table): fs(0.5+rate), pump*rate,
// sqrt(dt)*nr_i, sqrt(dt)/nr_i; the per-solve constants from the host in
// float32.  The square roots take the hardware's approximation, as
// dl_solve.cu's do.
//
// Noise is dl_solve.cu's stateless Philox4x32-10 (key seed + instance,
// counter (step, row, column/4, stream), word column % 4), a lane pair
// sharing each call and handing over two words by shuffle, so a stacked
// instance i draws what a solve with seed + i draws and ops/philox.py
// reproduces every word.  Padding columns draw no noise and so stay 0 (no
// clip would stop them growing).  The TPU kernels seed the hardware
// generator per grid program instead, which cannot be replayed.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ccvm_common.cuh"
#include "ccvm_mma.cuh"

namespace {

using namespace ccvm;

// Warps a block: 64 trajectories either way, two blocks per SM.
__host__ __device__ constexpr int block_warps(bool fuse) { return fuse ? 8 : 4; }

// The per-solve constants, taken once on the host in float32
// (ops/dl_variant_kernels.py _scalars), in the constant bank.
struct VariantScalars {
  float S, dt, noise_scale, two_g, S_d, span, mid, sc, alpha, qscale;
};
static_assert(sizeof(VariantScalars) == 10 * sizeof(float), "VariantScalars layout");

// Trajectories a warp owns, and each lane's float4s of state (c, then with
// FUSE 0 s) in shared memory.
__host__ __device__ constexpr int warp_rows(bool fuse) { return fuse ? 8 : 16; }
__host__ __device__ constexpr int own_float4s(int nt, bool fuse) {
  return fuse ? nt : 2 * nt;
}

// Shared-memory bytes of a block: Q's fragments, the per-column offsets and
// the lanes' own float4s (ops/build.py variant_launch_shape states the same).
__host__ __device__ constexpr long long variant_smem_bytes(int nt, bool fuse) {
  return 16LL * nt * nt * 32 + 32LL * nt + 16LL * own_float4s(nt, fuse) * 32 * block_warps(fuse);
}

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

// The lane's A fragment of a k-tile from its state z (columns 2t, 2t+1 of
// rows g and g+8 of the tile): v3 z itself, v2 x = z*(span/S_d) + mid.
template <bool V3>
__device__ __forceinline__ void a_fragment(const float4& z, const VariantScalars& p,
                                           float (&x)[4]) {
  if (V3) {
    x[0] = z.x; x[1] = z.z; x[2] = z.y; x[3] = z.w;
  } else {
    x[0] = z.x * p.sc + p.mid;
    x[1] = z.z * p.sc + p.mid;
    x[2] = z.y * p.sc + p.mid;
    x[3] = z.w * p.sc + p.mid;
  }
}

// The Philox words of the lane's columns 8j+2t+h (h = 0, 1) of n-tiles
// j = 2pp (wa) and 2pp+1 (wb) at trajectory `row`: the even lane of a pair
// draws tile 2pp, the odd lane tile 2pp+1 (cg, the counter's column word,
// is 2(2pp + odd) + t/2), and each hands the other the two words of its
// partner's columns (dl_solve.cu's sharing).
template <int NS>
__device__ __forceinline__ void pair_words(unsigned (&wa)[NS][2], unsigned (&wb)[NS][2],
                                           unsigned step, unsigned row, unsigned cg,
                                           bool odd, uint2 key) {
#pragma unroll
  for (int sidx = 0; sidx < NS; ++sidx) {
    const uint4 w = philox4x32_10(make_uint4(step, row, cg, (unsigned)sidx), key);
    const unsigned own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
    const unsigned r0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? w.x : w.z, 1);
    const unsigned r1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? w.y : w.w, 1);
    wa[sidx][0] = odd ? r0 : own0;
    wa[sidx][1] = odd ? r1 : own1;
    wb[sidx][0] = odd ? own0 : r0;
    wb[sidx][1] = odd ? own1 : r1;
  }
}

// One Euler-Maruyama step of one (c, s) element from its two matvec sums
// and its column's offset (v2 g3, v3 fb0), in the plain version's order;
// st = (fs(0.5+rate), pump*rate, sqrt(dt)*nr_i, sqrt(dt)/nr_i).
template <bool V3, bool NOISE>
__device__ __forceinline__ void element_step(float& c, float& s, float acc_c, float acc_s,
                                             float off, float z1, float z2,
                                             const float4& st, const VariantScalars& p) {
  const float cv = c, sv = s;
  const float c_pow = cv * cv;
  const float s_pow = sv * sv;
  float cn, sn;
  if (V3) {
    const float sum_pow = c_pow + s_pow;
    const float c_drift = -st.x * (acc_c * p.qscale + off) + (-1.0f + st.y - sum_pow) * cv;
    const float s_drift = -st.x * (acc_s * p.qscale + off) + (-1.0f - st.y - sum_pow) * sv;
    cn = cv + p.dt * c_drift;
    sn = sv + p.dt * s_drift;
    if (NOISE) {
      const float diff = p.two_g * sqrt_approx(sum_pow + 0.5f);
      cn = cn + (diff * st.z) * z1;
      sn = sn + (diff * st.w) * z2;
    }
  } else {
    const float fb_c = 0.25f * acc_c * p.sc;
    const float fb_s = 0.25f * acc_s * p.sc;
    const float c_drift = -st.x * (fb_c + off) + (-1.0f + st.y - c_pow - s_pow) * cv;
    const float s_drift = -st.x * (fb_s + off) + (-1.0f - st.y - c_pow - s_pow) * sv;
    cn = cv + p.dt * c_drift;
    sn = sv + p.dt * s_drift;
    if (NOISE) {
      const float diff = p.two_g * sqrt_approx(c_pow + s_pow + 0.5f);
      cn = cn + diff * (z1 * st.z);
      sn = sn + diff * (z2 * st.w);
    }
  }
  c = cn;
  s = sn;
}

// The element's two draws from its words, scaled; none at a padding column.
template <int RNG, int NS>
__device__ __forceinline__ void draws(const unsigned (&wa)[NS][2], const unsigned (&wb)[NS][2],
                                      int jj, int h, bool real, const VariantScalars& p,
                                      float& z1, float& z2) {
  unsigned w[NS];
#pragma unroll
  for (int sidx = 0; sidx < NS; ++sidx) w[sidx] = jj ? wb[sidx][h] : wa[sidx][h];
  harness_pair<RNG>(w, z1, z2);
  z1 = real ? z1 * p.noise_scale : 0.0f;
  z2 = real ? z2 * p.noise_scale : 0.0f;
}

template <bool V3, bool FUSE, int UNROLL, bool NOISE, int RNG, int NT>
__global__ void __launch_bounds__(32 * block_warps(FUSE), 2)
dl_variant_kernel(const float* __restrict__ q, const float* __restrict__ v,
                  const float4* __restrict__ steps, float* __restrict__ c_out,
                  float* __restrict__ s_out, int batch, int n, int iterations,
                  unsigned long long seed, VariantScalars p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NP = 8 * NT;
  constexpr int kRows = warp_rows(FUSE);
  constexpr int kOwn = own_float4s(NT, FUSE);
  constexpr int NS = harness_streams(RNG);
  float4* qf = reinterpret_cast<float4*>(smem);  // (k-tile, n-tile, lane)
  float* offs = smem + 4 * NT * NT * 32;         // (NP): v2 g3, v3 fb0
  float4* own = reinterpret_cast<float4*>(offs + NP);

  const int inst = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* qi = q + (size_t)inst * n * n;
  load_q_fragments<NT>(qf, qi, n, tid);
  for (int j = tid; j < NP; j += blockDim.x) {
    float off = 0.0f;
    if (j < n) {
      const float g3 = v[(size_t)inst * n + j] * p.span / (2.0f * p.S_d);
      if (V3) {
        float colsum = 0.0f;
        for (int k = 0; k < n; ++k) colsum += qi[k * n + j];
        off = p.alpha * p.mid * colsum + g3;
      } else {
        off = g3;
      }
    }
    offs[j] = off;
  }
  __syncthreads();  // Q's fragments and the offsets are in

  // The lane's state, n-tile j's float4 at my[j * 32]: FUSE 1 (c h=0, c h=1,
  // s h=0, s h=1) of its trajectory g at columns 8j+2t+h; FUSE 0 c of its
  // trajectories g (h=0, 1) and g+8 (h=0, 1), then s likewise at
  // my[(NT + j) * 32].
  float4* my = own + (size_t)warp * kOwn * 32 + lane;
#pragma unroll
  for (int e = 0; e < kOwn; ++e) my[e * 32] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const uint2 key = seed_key(seed, inst);

  const auto step = [&](int i) {
    const float4 st = __ldg(steps + i);
    // FUSE 1: acc holds rows g (c) and g+8 (s).  FUSE 0: one pass a tile, in
    // a rolled loop (one copy of the chain's code): the c tile's sums, kept
    // in acs, then the s tile's in acc.
    float acc[NT][4], acs[FUSE ? 1 : NT][4];
#pragma unroll 1
    for (int pass = 0; pass < (FUSE ? 1 : 2); ++pass) {
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        float x[4];
        a_fragment<V3>(my[(pass * NT + kt) * 32], p, x);
        mma_ktile<NT>(acc, qf, kt, lane, x);
      }
      if constexpr (!FUSE) {
        if (pass == 0) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acs[j][e] = acc[j][e];
        }
      }
    }

    // The counter's row and column words, from the ids read anew each step
    // (dl_solve.cu: held across the loop they would spill).
    unsigned ln;
    const unsigned row_i = lane_row<kRows>(ln);
    const unsigned cg0 = 2 * (ln & 1) + ((ln >> 1) & 1);
    const bool odd = ln & 1;
    const int col0 = 2 * (int)(ln & 3);
    if constexpr (FUSE) {
#pragma unroll
      for (int pp = 0; pp < (NT + 1) / 2; ++pp) {
        unsigned wa[NS][2], wb[NS][2];
        if (NOISE) pair_words<NS>(wa, wb, (unsigned)i, row_i, cg0 + 4 * pp, odd, key);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * pp + jj;
          if (j >= NT) continue;
          float4 z = my[j * 32];
          const float2 off = *reinterpret_cast<const float2*>(offs + 8 * j + col0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float z1 = 0.0f, z2 = 0.0f;
            if (NOISE) draws<RNG, NS>(wa, wb, jj, h, 8 * j + col0 + h < n, p, z1, z2);
            element_step<V3, NOISE>(h ? z.y : z.x, h ? z.w : z.z, acc[j][h], acc[j][2 + h],
                                    h ? off.y : off.x, z1, z2, st, p);
          }
          my[j * 32] = z;
        }
      }
    } else {
      // Row g, then row g+8 (a rolled loop: one copy of the code), each a
      // half (float2) of the lane's float4s of c and of s.
#pragma unroll 1
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int pp = 0; pp < (NT + 1) / 2; ++pp) {
          unsigned wa[NS][2], wb[NS][2];
          if (NOISE)
            pair_words<NS>(wa, wb, (unsigned)i, row_i + 8 * rr, cg0 + 4 * pp, odd, key);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * pp + jj;
            if (j >= NT) continue;
            float2* cp = reinterpret_cast<float2*>(my + j * 32) + rr;
            float2* sp = reinterpret_cast<float2*>(my + (NT + j) * 32) + rr;
            float2 zc = *cp, zs = *sp;
            const float2 off = *reinterpret_cast<const float2*>(offs + 8 * j + col0);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float z1 = 0.0f, z2 = 0.0f;
              if (NOISE) draws<RNG, NS>(wa, wb, jj, h, 8 * j + col0 + h < n, p, z1, z2);
              const float fb_c = rr ? acs[j][2 + h] : acs[j][h];
              const float fb_s = rr ? acc[j][2 + h] : acc[j][h];
              element_step<V3, NOISE>(h ? zc.y : zc.x, h ? zs.y : zs.x, fb_c, fb_s,
                                      h ? off.y : off.x, z1, z2, st, p);
            }
            *cp = zc;
            *sp = zs;
          }
        }
      }
    }
  };

  const int main_iters = iterations / UNROLL * UNROLL;
#pragma unroll 1
  for (int i0 = 0; i0 < main_iters; i0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      step(i0 + u);
      // FUSE 1: the block's warps stay within a step of each other, so they
      // share the instruction cache's lines of the unrolled body.
      if (FUSE && UNROLL > 1) __syncthreads();
    }
  }
#pragma unroll 1
  for (int i = main_iters; i < iterations; ++i) step(i);

  unsigned ln;
  const int row_g = (int)lane_row<kRows>(ln);
  const int col0 = 2 * (int)(ln & 3);
#pragma unroll
  for (int rr = 0; rr < (FUSE ? 1 : 2); ++rr) {
    const int row = row_g + 8 * rr;
    if (row >= batch) continue;
    const size_t base = ((size_t)inst * batch + row) * n;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 z = my[j * 32];
      // FUSE 1: c (x, y), s (z, w); FUSE 0: row rr's half of c and of s.
      const float4 zs = FUSE ? z : my[(NT + j) * 32];
      const float2 cz = FUSE || rr == 0 ? make_float2(z.x, z.y) : make_float2(z.z, z.w);
      const float2 sz = FUSE ? make_float2(z.z, z.w)
                             : rr == 0 ? make_float2(zs.x, zs.y) : make_float2(zs.z, zs.w);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * j + col0 + h;
        if (col < n) {
          c_out[base + col] = clamp_keep_nan(h ? cz.y : cz.x, p.S);
          s_out[base + col] = h ? sz.y : sz.x;
        }
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
#ifndef CCVM_NT
#define CCVM_NT 9
#endif

namespace {

static_assert(CCVM_NT >= 1 && CCVM_NT <= 16, "NT: 1 to 16 n-tiles");
constexpr bool kFuse = CCVM_FUSE != 0;
auto const kKernel = &dl_variant_kernel<CCVM_V3 != 0, kFuse, CCVM_UNROLL, CCVM_NOISE != 0,
                                        CCVM_RNG, CCVM_NT>;

// Threads and shared-memory bytes of a launch; non-zero when this build
// does not take n or the block's rows.
int variant_launch_shape(int n, int rows_per_block, int* threads, long long* smem) {
  if ((n + 7) / 8 != CCVM_NT || n < 1 || rows_per_block != block_warps(kFuse) * warp_rows(kFuse))
    return 1;
  *threads = 32 * block_warps(kFuse);
  *smem = variant_smem_bytes(CCVM_NT, kFuse);
  return 0;
}

}  // namespace

extern "C" {

// q (I, n, n), v (I, n), steps (iterations, 4), c_out / s_out (I, batch, n):
// float32, contiguous, on the device.  scalars: 10 host floats in
// VariantScalars order.  Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch.
int ccvm_dl_variant(const float* q, const float* v, const float* steps, float* c_out,
                    float* s_out, int num_instances, int batch, int n, int iterations,
                    unsigned long long seed, const float* scalars, int rows_per_block,
                    void* stream) {
  VariantScalars p;
  memcpy(&p, scalars, sizeof(VariantScalars));
  int threads;
  long long smem;
  if (variant_launch_shape(n, rows_per_block, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, num_instances);
  kKernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      q, v, reinterpret_cast<const float4*>(steps), c_out, s_out, batch, n, iterations,
      seed, p);
  return (int)cudaGetLastError();
}

// Blocks of this specialisation the card keeps resident per SM at problem
// size n (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns a
// cudaError_t.
int ccvm_dl_variant_blocks_per_sm(int n, int rows_per_block, int* blocks) {
  int threads;
  long long smem;
  if (variant_launch_shape(n, rows_per_block, &threads, &smem))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kKernel, threads,
                                                            (size_t)smem);
}

}  // extern "C"
