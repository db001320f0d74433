// FP64 tensor-core building block shared by every kernel of the port
// (stepped_trsm.cuh, stepped_syrk.cuh). Sm_90a, f64.
//
// Hopper has no wgmma for f64: the FP64 tensor cores (67 TFLOP/s dense on
// an H100 SXM, twice the plain DFMA rate) are reached through the warp-level
// mma.sync. Shape m16n8k8 (PTX ISA 7.8, sm_90); lane = 4g + t holds
//   A (16 x 8, row): A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]
//   B (8 x 8, col):  B[t][g], B[t + 4][g]
//   C (16 x 8):      C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1]
// It measured faster than the m8n8k4 shape on the port's kernels, with the
// same bits: each output is accumulated over k in the same order (PERF.md).
// warp_mma() multiplies a warp tile of (8 MI) x (8 NJ) outputs, kept as
// 8-row blocks acc[i][j] = C[8i + g][8j + 2t + {0, 1}], over a depth of
// KDEPTH from shared memory. Operands are laid out so that a warp's
// fragment loads hit 32 distinct banks: every leading dimension the kernels
// use is 4 (mod 16) doubles, so element (g, t) of a fragment lands at
// 4g + t or 4t + g (mod 16) within each half-warp's 128 bytes.
//
// Operands reach shared memory with cp.async (16 bytes a copy) in a ring of
// STAGES buffers: pipeline() keeps STAGES - 1 chunks in flight while the
// warps multiply the oldest one. Two copy policies: .ca (may allocate in
// L1; for inputs no kernel writes) and .cg (L2 only; for data other blocks
// of the same launch write, which a stale L1 line must never serve).
// The tile:: helpers at the end (zeroing, pairs, copy widths) serve both
// scalar types.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dmma {

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// d0 (row g) and d1 (row g + 8) += a b on the FP64 tensor cores
__device__ __forceinline__ void mma_16x8x8(double (&d0)[2], double (&d1)[2],
                                           const double (&a)[4],
                                           const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d0[0]), "+d"(d0[1]), "+d"(d1[0]), "+d"(d1[1])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// acc[i][j] += (-) sum_k A(8i + g, k) B(k, 8j + 2t + {0, 1}) over
// k < KDEPTH, with A(r, k) at A[r * A_RS + k * A_KS] and B(k, c) at
// B[k * LDB + c].
template <int MI, int NJ, int KDEPTH, int A_RS, int A_KS, int LDB, bool NEG>
__device__ __forceinline__ void warp_mma(double (&acc)[MI][NJ][2],
                                         const double* A, const double* B) {
  const int g = lane_g(), t = lane_t();
  static_assert(MI % 2 == 0 && KDEPTH % 8 == 0, "m16n8k8 tiles");
#pragma unroll
  for (int k = 0; k < KDEPTH; k += 8) {
    double a[MI / 2][4], b[NJ][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[i][q] = A[(16 * i + 8 * (q & 1) + g) * A_RS +
                    (k + t + 4 * (q >> 1)) * A_KS];
        if (NEG) a[i][q] = -a[i][q];
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) b[j][q] = B[(k + t + 4 * q) * LDB + 8 * j + g];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8(acc[2 * i][j], acc[2 * i + 1][j], a[i], b[j]);
  }
}

// 16-byte copy global -> shared; an invalid copy writes zeros and reads
// nothing (src-size 0), so `src` need only be some valid address.
__device__ __forceinline__ void cp_async_cg(void* dst, const void* src,
                                            bool valid = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Runs compute(c, stage) over chunks c < nchunks in order, with
// issue(c, stage) copying chunk c into ring buffer `stage` STAGES - 1
// chunks ahead. Every thread of the block calls it with the same nchunks.
// On return every copy has landed and every warp is past its last compute,
// so the ring may be reused.
template <int STAGES, class Issue, class Compute>
__device__ __forceinline__ void pipeline(int nchunks, Issue&& issue,
                                         Compute&& compute) {
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nchunks) issue(p, p);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    // chunks 0..c have landed; every warp is done with chunk c - 1
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = c + STAGES - 1;
    if (next < nchunks) issue(next, next % STAGES);
    cp_async_commit();
    compute(c, c % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Lets `kernel` take `bytes` (over 48 KB) of dynamic shared memory.
template <class Kernel>
cudaError_t set_smem(Kernel* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace dmma

// Helpers the shared device code calls for its scalar type T (double or
// float).
namespace tile {

template <class T, int MI, int NJ>
__device__ __forceinline__ void zero(T (&acc)[MI][NJ][2]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = T(0);
}

// two consecutive elements, moved as one 8- or 16-byte word
template <class T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

template <class T>
__device__ __forceinline__ typename Pair<T>::type pair(T x, T y) {
  return {x, y};
}

// elements per 16-byte cp.async copy
template <class T>
constexpr int VEC = 16 / (int)sizeof(T);

}  // namespace tile
