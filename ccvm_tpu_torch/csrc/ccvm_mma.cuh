// The 3xTF32 tensor-core matvec that the DL kernels share: the production
// DL kernel's (dl_solve.cu, MMA = 1) and the race harness's variants
// (dl_variants.cu).  Both run x @ Q as a chain of m16n8k8 mma.sync:
//
//   * a warp's m16 tile holds 16 rows of x (dl_solve.cu: 8 trajectories'
//     x of c in rows 0-7 and their x of s in rows 8-15); lane (g = lane/4,
//     t = lane%4) holds, for every n-tile j, columns 8j+2t and 8j+2t+1 of
//     rows g and g+8, in the mma accumulator layout (acc[j][0..1] row g,
//     acc[j][2..3] row g+8);
//   * the accumulator layout doubles as the A layout: A's k slots t and t+4
//     are taken to be columns 2t and 2t+1 of the k-tile, and Q's rows are
//     permuted to match once per block (load_q_fragments), so a lane builds
//     its A fragment from its own state and x never goes through shared
//     memory;
//   * 3xTF32: Q is split once per block into hi = rna(q) and lo = rna(q-hi),
//     stored in fragment order ((hi, hi, lo, lo) per lane: one 16-byte load
//     per fragment, conflict-free); x is split the same way on the fly; each
//     product is lo*hi + hi*lo + hi*hi, accumulated in fp32 (mma_ktile).
//
// The tensor cores' fp32 accumulation truncates, so the error grows with
// the sums' size; each kernel says what it does about that.  ops/build.py
// names every library by a hash of its source and of this header.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ccvm {

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

// The lane's first trajectory row (of the launch) and its lane id, from
// the ids read anew: values the compiler cannot carry across a step loop,
// where they would spill.  A warp owns kWarpRows trajectories (8: rows g;
// 16: rows g and g+8).
template <int kWarpRows = 8>
__device__ __forceinline__ unsigned lane_row(unsigned& ln) {
  unsigned tx, bx;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(ln));
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tx));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  return bx * (blockDim.x / (32 / kWarpRows)) + (tx >> 5) * kWarpRows + (ln >> 2);
}

// Q's B fragments of one instance (qi, n x n, row-major) into qf, (k-tile,
// n-tile, lane), split into TF32 (hi, hi, lo, lo), with k permuted: slot t
// is row 8kt+2t, slot t+4 row 8kt+2t+1; zero-padded to 8 NT x 8 NT.  Every
// thread of the block takes its share; the caller synchronises.
template <int NT>
__device__ __forceinline__ void load_q_fragments(float4* __restrict__ qf,
                                                 const float* __restrict__ qi, int n,
                                                 int tid) {
  for (int e = tid; e < NT * NT * 32; e += blockDim.x) {
    const int L = e & 31, f = e >> 5;
    const int k0 = 8 * (f / NT) + 2 * (L & 3), col = 8 * (f % NT) + (L >> 2);
    const float b0 = (k0 < n && col < n) ? qi[k0 * n + col] : 0.0f;
    const float b1 = (k0 + 1 < n && col < n) ? qi[(k0 + 1) * n + col] : 0.0f;
    const float h0 = tf32_round(b0), h1 = tf32_round(b1);
    qf[e] = make_float4(h0, h1, tf32_round(b0 - h0), tf32_round(b1 - h1));
  }
}

// acc[j] += (rows g, g+8 of the tile) x (k-tile kt of Q) for every n-tile j:
// x the lane's A fragment (a0 row g slot t, a1 row g+8 slot t, a2 row g
// slot t+4, a3 row g+8 slot t+4), split into TF32 hi and lo here; each Q
// fragment is one 16-byte load, feeding lo*hi, hi*lo and hi*hi.
template <int NT>
__device__ __forceinline__ void mma_ktile(float (&acc)[NT][4],
                                          const float4* __restrict__ qf, int kt,
                                          int lane, const float (&x)[4]) {
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

}  // namespace ccvm
