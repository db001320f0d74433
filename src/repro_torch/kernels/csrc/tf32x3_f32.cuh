// 3xTF32 building block of every f32 product of the port, the TRSM core's
// (stepped_trsm.cuh) and the SYRK tile's (stepped_syrk.cuh), and the
// products both call for either scalar type. Sm_90a.
//
// The TF32 tensor cores (495 TFLOP/s dense on an H100 SXM, against 67 for
// FFMA) multiply operands with a 10-bit mantissa: one TF32 product lands
// about 1e-3 from an f32 one, a different result, not a faster one. A
// 3xTF32 product keeps f32 accuracy: each operand is split, in registers as
// it is loaded, into two TF32 values,
//   big = cvt.rna.tf32(x),  small = cvt.rna.tf32(x - big)   (x - big exact),
// and a b = small_a big_b + big_a small_b + big_a big_b, the small terms
// first (the small_a small_b term, about 2^-22 of a b, is dropped). The
// tensor cores' f32 accumulation truncates rather than rounds, which over
// a reduction thousands of products deep biases the sum toward zero (it
// put feti-heat-2d's f32 TRSM about 2e-6 from the f64 one; PERF.md): so
// the three products of each k8 step go into a fresh accumulator, and that
// is added to the running sum with an f32 add, which rounds to nearest.
// Each output sums over k in a fixed order.
//
// mma.sync m16n8k8 .tf32 takes its A, B and C fragments where the f64
// m16n8k8 of dmma_f64.cuh does (lane 4g + t: A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4]; B[t][g], B[t + 4][g]; C[g][2t, 2t + 1],
// C[g + 8][2t, 2t + 1]), so one staging and one accumulator layout serve
// both types. For 4-byte words a fragment load is conflict-free when a
// row-major A operand's leading dimension is 4 (mod 8) words (bank 4g + t,
// 12g + t, ...) and a B operand's, or a k-major A operand's (the SYRK
// tile's), 8 (mod 32) (bank 8t + g); stepped_trsm.cuh and stepped_syrk.cuh
// size their f32 buffers so.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_f64.cuh"

namespace tf32x3 {

// x = big + small, both TF32 values in 32-bit registers
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// d0 (row g) and d1 (row g + 8) += a b, one TF32 product
__device__ __forceinline__ void mma_16x8x8(float (&d0)[2], float (&d1)[2],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d1[0]), "+f"(d1[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d0 (row g) and d1 (row g + 8) = a b, one TF32 product into a fresh
// accumulator (C is zero)
__device__ __forceinline__ void mma_16x8x8_new(float (&d0)[2], float (&d1)[2],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d0[0]), "=f"(d0[1]), "=f"(d1[0]), "=f"(d1[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// d0, d1 += a b from split fragments: the three TF32 products summed in a
// fresh accumulator, then added with round-to-nearest f32 adds
__device__ __forceinline__ void mma3_16x8x8(float (&d0)[2], float (&d1)[2],
                                            const uint32_t (&a_hi)[4],
                                            const uint32_t (&a_lo)[4],
                                            const uint32_t (&b_hi)[2],
                                            const uint32_t (&b_lo)[2]) {
  float t0[2], t1[2];
  mma_16x8x8_new(t0, t1, a_lo, b_hi);
  mma_16x8x8(t0, t1, a_hi, b_lo);
  mma_16x8x8(t0, t1, a_hi, b_hi);
  d0[0] += t0[0];
  d0[1] += t0[1];
  d1[0] += t1[0];
  d1[1] += t1[1];
}

// d0, d1 += a b at f32 accuracy, from f32 fragments
__device__ __forceinline__ void mma3_16x8x8(float (&d0)[2], float (&d1)[2],
                                            const float (&a)[4],
                                            const float (&b)[2]) {
  uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) split(a[q], a_hi[q], a_lo[q]);
#pragma unroll
  for (int q = 0; q < 2; ++q) split(b[q], b_hi[q], b_lo[q]);
  mma3_16x8x8(d0, d1, a_hi, a_lo, b_hi, b_lo);
}

// acc[i][j] += (-) sum_k A(8i + g, k) B(k, 8j + 2t + {0, 1}) over
// k < KDEPTH, with A(r, k) at A[r * A_RS + k * A_KS] and B(k, c) at
// B[k * LDB + c]: dmma::warp_mma's contract at f32. Each k8 step's three
// passes run over every (i, j) before the next, so the MI / 2 * NJ fresh
// accumulators' chains interleave, then join acc with f32 adds. The k8
// steps are not unrolled: unrolled, ptxas keeps several steps' fragments
// and accumulators live, and the f32 row-split core needs more than the
// 168 registers a thread that three blocks a SM leave it.
template <int MI, int NJ, int KDEPTH, int A_RS, int A_KS, int LDB, bool NEG>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][2],
                                         const float* A, const float* B) {
  const int g = dmma::lane_g(), t = dmma::lane_t();
  static_assert(MI % 2 == 0 && KDEPTH % 8 == 0, "m16n8k8 tiles");
#pragma unroll 1
  for (int k = 0; k < KDEPTH; k += 8) {
    uint32_t a_hi[MI / 2][4], a_lo[MI / 2][4], b_hi[NJ][2], b_lo[NJ][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = A[(16 * i + 8 * (q & 1) + g) * A_RS +
                          (k + t + 4 * (q >> 1)) * A_KS];
        split(NEG ? -v : v, a_hi[i][q], a_lo[i][q]);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split(B[(k + t + 4 * q) * LDB + 8 * j + g], b_hi[j][q], b_lo[j][q]);
    float step[MI][NJ][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8_new(step[2 * i][j], step[2 * i + 1][j], a_lo[i], b_hi[j]);
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8(step[2 * i][j], step[2 * i + 1][j], a_hi[i], b_lo[j]);
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8(step[2 * i][j], step[2 * i + 1][j], a_hi[i], b_hi[j]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j][0] += step[i][j][0];
        acc[i][j][1] += step[i][j][1];
      }
  }
}

}  // namespace tf32x3

// The products of the TRSM core and the SYRK tile for their scalar type T
// (double: the FP64 tensor cores; float: 3xTF32).
namespace tile {

template <int MI, int NJ, int KD, int A_RS, int A_KS, int LDB, bool NEG>
__device__ __forceinline__ void mma(double (&acc)[MI][NJ][2],
                                    const double* A, const double* B) {
  dmma::warp_mma<MI, NJ, KD, A_RS, A_KS, LDB, NEG>(acc, A, B);
}

template <int MI, int NJ, int KD, int A_RS, int A_KS, int LDB, bool NEG>
__device__ __forceinline__ void mma(float (&acc)[MI][NJ][2], const float* A,
                                    const float* B) {
  tf32x3::warp_mma<MI, NJ, KD, A_RS, A_KS, LDB, NEG>(acc, A, B);
}

// one m16n8k8 step on register fragments (dmma_f64.cuh's layout)
__device__ __forceinline__ void frag_mma(double (&d0)[2], double (&d1)[2],
                                         const double (&a)[4],
                                         const double (&b)[2]) {
  dmma::mma_16x8x8(d0, d1, a, b);
}

__device__ __forceinline__ void frag_mma(float (&d0)[2], float (&d1)[2],
                                         const float (&a)[4],
                                         const float (&b)[2]) {
  tf32x3::mma3_16x8x8(d0, d1, a, b);
}

}  // namespace tile
