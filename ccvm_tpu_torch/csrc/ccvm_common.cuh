// Device code shared by the whole-solve kernels of csrc/ (dl_solve.cu for
// DL-CCVM, mf_solve.cu for MF-CCVM, langevin_solve.cu for Langevin and
// pumped Langevin): the thread tile, Philox4x32-10, the four Wiener
// transforms of ccvm_tpu/ops/pallas_kernels.py:152-319 (pair and single
// draws), the safety clip, the square root approximation, the division by
// a known divisor and the in-loop Adam update (pallas_kernels.py:465-480).
// ops/philox.py reproduces the noise bit for bit.  ops/build.py names each
// library by a hash of its .cu and of every header here, so an edit to this
// file rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ccvm {

constexpr int TR = 4;  // trajectory rows per thread
constexpr int TC = 4;  // columns per thread = words of one Philox call
constexpr int kMaxThreads = 256;

enum Rng { kPopcount32 = 0, kPopcount16 = 1, kPopcount = 2, kBoxMuller = 3 };

// A segment launch (the CCVM_SEG builds of each template; the wrappers'
// *_solve_segment): `iterations` steps from absolute step `start` of a solve
// of `total` steps, from a given state, with the whole state written back,
// the Adam moments included.  The Philox counter is keyed by the absolute
// step and the entry point hands the kernel the step table from row `start`
// on, so a solve cut into segments equals the whole launch bit for bit; the
// step loop itself counts from 0, as a whole solve's does (an absolute loop
// index cost pumped Langevin a spill).  The host passes the same layout
// (ops/build.py Segment); the kernel takes it by value, in the constant
// bank.  Every launch carries one (a whole solve's is zero but for
// `total` and `first_block`).
//
// A data-parallel rank's launch (ccvm_tpu_torch/parallel) holds the rows
// row_base .. row_base + batch - 1 of a wider solve: its entry point starts
// the grid row_base / rows_per_block blocks early (row_base is a multiple of
// the block's rows), those blocks return at once (`first_block`), and the
// output and state pointers are shifted back by row_base rows.  Every other
// block computes its rows' global ids from blockIdx as a launch of the whole
// batch does, so its Philox counters are the single launch's, and the step
// loop is not touched (a row offset added in it spilled the DL-Adam and MF
// builds).
struct Segment {
  const float* in[6];  // the state at step `start`, in the kernel's order;
                       // in[0] nullptr: the solve's initial state
  float* out[6];       // the moments at the end, in the kernel's order
  float* clamped;      // DL: c clamped to +-S at the end (nullptr: none)
  int start;           // absolute step of the launch's first step
  int total;           // the whole solve's steps (rows of the step table)
  int first_block;     // blocks below it hold no row of the launch
};

// `p` shifted back by `rows` rows of `n` floats (a data-parallel launch's
// outputs and state, indexed by global row); nullptr stays nullptr.
template <class T>
inline T* shifted(T* p, int rows, int n) {
  return p == nullptr ? p
                      : reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) -
                                             (uintptr_t)rows * (uintptr_t)n * sizeof(float));
}

// Philox streams (counter word 3) a pair transform consumes per element.
__host__ __device__ constexpr int streams_of(int rng) {
  return rng == kPopcount16 ? 1 : rng == kPopcount ? 6 : 2;
}

// ... and a single draw: the first normal of the pair, from the first
// streams (a single popcount16 draw is a popcount32 one).
__host__ __device__ constexpr int streams_one_of(int rng) {
  return rng == kPopcount ? 3 : rng == kBoxMuller ? 2 : 1;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The Philox key of seed + instance.
__device__ __forceinline__ uint2 seed_key(unsigned long long seed, int inst) {
  const unsigned long long s = seed + (unsigned long long)inst;
  return make_uint2((unsigned)s, (unsigned)(s >> 32));
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The Philox words of one element of a one-step launch (the CCVM_EXT
// builds of each template, for a tensor-parallel solve), at its global row
// and column: the counter is (step, row, column / 4, stream) and the word
// column % 4, as every whole-solve launch draws them.
template <int NS>
__device__ __forceinline__ void element_words(unsigned* w, int step, int row, int col,
                                              unsigned long long seed) {
  const uint2 key = seed_key(seed, 0);
#pragma unroll
  for (int st = 0; st < NS; ++st)
    w[st] = word_of(philox4x32_10(make_uint4((unsigned)step, (unsigned)row,
                                             (unsigned)col >> 2, (unsigned)st),
                                  key),
                    col & 3);
}

// The four Wiener transforms of pallas_kernels.py:152-254 on Philox words
// (w[k] is the element's word of stream k).
template <int RNG>
__device__ __forceinline__ void normal_pair(const unsigned* w, float& z1,
                                            float& z2) {
  if constexpr (RNG == kPopcount16) {
    z1 = (float)(__popc(w[0] & 0xFFFFu) - 8) * 0.5f;
    z2 = (float)(__popc(w[0] >> 16) - 8) * 0.5f;
  } else if constexpr (RNG == kPopcount32) {
    const float inv = 0.35355339059327373f;  // 1/sqrt(8)
    z1 = (float)(__popc(w[0]) - 16) * inv;
    z2 = (float)(__popc(w[1]) - 16) * inv;
  } else if constexpr (RNG == kPopcount) {
    const float inv = 0.24935148656368256f;  // 1/sqrt(16 + 1/12)
    const float u23 = 1.0f / 8388608.0f;
    const float ua = (float)(w[2] & 0x7FFFFFu) * u23;
    const float ub = (float)(w[5] & 0x7FFFFFu) * u23;
    z1 = ((float)(__popc(w[0]) + __popc(w[1]) - 32) + (ua - 0.5f)) * inv;
    z2 = ((float)(__popc(w[3]) + __popc(w[4]) - 32) + (ub - 0.5f)) * inv;
  } else {
    const float u23 = 1.0f / 8388608.0f;
    const float u1 = ((float)(w[0] & 0x7FFFFFu) + 1.0f) * u23;
    const float u2 = (float)(w[1] & 0x7FFFFFu) * u23;
    const float r = sqrtf(-2.0f * logf(u1));
    const float theta = 6.2831854820251465f * u2;
    z1 = r * cosf(theta);
    z2 = r * sinf(theta);
  }
}

// The single draw of _noise_one (pallas_kernels.py:301-319): the first
// normal of the pair, from streams_one_of(RNG) words.
template <int RNG>
__device__ __forceinline__ float normal_one(const unsigned* w) {
  if constexpr (RNG == kPopcount16 || RNG == kPopcount32) {
    return (float)(__popc(w[0]) - 16) * 0.35355339059327373f;
  } else if constexpr (RNG == kPopcount) {
    const float ua = (float)(w[2] & 0x7FFFFFu) * (1.0f / 8388608.0f);
    return ((float)(__popc(w[0]) + __popc(w[1]) - 32) + (ua - 0.5f)) *
           0.24935148656368256f;
  } else {
    const float u23 = 1.0f / 8388608.0f;
    const float u1 = ((float)(w[0] & 0x7FFFFFu) + 1.0f) * u23;
    const float u2 = (float)(w[1] & 0x7FFFFFu) * u23;
    return sqrtf(-2.0f * logf(u1)) * cosf(6.2831854820251465f * u2);
  }
}

__device__ __forceinline__ float clip(float x, float b) {
  return fminf(fmaxf(x, -b), b);
}

// The hardware's square root approximation (MUFU, a few ulp), without the
// IEEE sequence's fix-up branch and the subroutine call of its slow path.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// a / b rounded as the IEEE division rounds it, for a divisor known ahead
// with inv = 1/b rounded to nearest: the product by inv, then its residual
// a - q b (one FMA) times inv added back, Markstein's correction
// (Muller et al., Handbook of Floating-Point Arithmetic, division with an
// FMA).  tests/test_torch_mf_redesign.py emulates the three roundings
// exactly against the IEEE quotient over every float32 significand of a,
// for the MF kernel's divisors.  Three instructions and no branch, where
// a / b takes a reciprocal, its Newton refinement and a range check.
__device__ __forceinline__ float div_rn(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  const float r = __fmaf_rn(-q, b, a);
  return __fmaf_rn(r, inv, q);
}

// Adam filtering of one gradient element (the plain version's
// adam_moment_update, dynamics/common.py), every product and sum spelled
// out in its order; P carries beta1, one_minus_beta1, beta2,
// one_minus_beta2 and alpha.  b1i, b2i are the step's bias corrections
// 1 - beta^(i+1) and inv_b1i, inv_b2i their reciprocals rounded to nearest
// (from the kernel's step table), so m / b1i and v / b2i are div_rn's IEEE
// quotients; alpha mhat / (sqrt(vhat) + eps) takes the hardware's square
// root and division (a few ulp), whose IEEE sequences' slow-path calls
// would cost the element loop its registers.
template <bool BETA2_ONE, bool ADD_ASSIGN, class P>
__device__ __forceinline__ float adam(float grad, float& m, float& v, float b1i,
                                      float inv_b1i, float b2i, float inv_b2i,
                                      const P& p) {
  m = __fadd_rn(__fmul_rn(p.beta1, m), __fmul_rn(p.one_minus_beta1, grad));
  const float mhat = div_rn(m, b1i, inv_b1i);
  float update;
  if (BETA2_ONE) {
    update = __fmul_rn(p.alpha, mhat);
  } else {
    v = __fadd_rn(__fmul_rn(p.beta2, v), __fmul_rn(p.one_minus_beta2, __fmul_rn(grad, grad)));
    const float vhat = div_rn(v, b2i, inv_b2i);
    update = __fdividef(__fmul_rn(p.alpha, mhat), __fadd_rn(sqrt_approx(vhat), 1e-8f));
  }
  return ADD_ASSIGN ? __fadd_rn(grad, update) : update;
}

// Threads and shared-memory bytes of a launch whose block holds Q
// (np x np) and `x_arrays` x rows of stride np + 4 per trajectory; non-zero
// when the tile does not fit one block (ops/build.py launch_shape picks
// rows_per_block).
inline int launch_shape(int n, int rows_per_block, int x_arrays, int* threads,
                        long long* smem_bytes) {
  const int np = (n + TC - 1) / TC * TC;
  const int groups = np / TC;
  const int rgroups = rows_per_block / TR;
  *threads = groups * rgroups;
  *smem_bytes = (long long)(np * np + x_arrays * rows_per_block * (np + 4)) *
                (long long)sizeof(float);
  return (*threads <= kMaxThreads && rows_per_block % TR == 0) ? 0 : 1;
}

}  // namespace ccvm
