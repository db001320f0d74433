// FP32 building block of the port's f32 kernels (stepped_trsm.cuh,
// stepped_syrk.cuh), and the one product the shared device code calls for
// either scalar type. Sm_90a.
//
// The TPU kernels accumulate sub-f64 inputs in f32; so do these, on plain
// FFMA. They do not use the TF32 tensor cores: TF32 keeps a 10-bit
// mantissa, which would put a kernel about 1e-3 away from its f32 plain
// version (cuBLAS SGEMM with TF32 off). A 3xTF32 split is left for later.
//
// fp32::warp_mma() keeps the fragment layout of dmma::warp_mma() (lane
// 4g + t owns rows 8i + g and columns 8j + 2t + {0, 1} of the warp tile), so
// the staging, accumulator loads and stores of the shared device code serve
// both types; only the product differs. Per k a lane loads MI values of A
// (one per row it owns; lanes of equal g read the same word, a broadcast)
// and NJ float2 of B (lanes of equal t read the same pair), then issues
// 2 MI NJ FFMA in a fixed order: each output sums over k in order, in f32.
//
// Shared-memory banks for 4-byte words: the A operand of the TRSM (row-major,
// leading dimension A_LD = 20 words) puts the 8 rows a warp reads at
// 20g (mod 32) = {0, 20, 8, 28, 16, 4, 24, 12}: 8 distinct banks; every
// other operand (B, Y and the SYRK's k-major panels) is read as contiguous
// runs of one row. So the paddings chosen for 8-byte words serve here too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_f64.cuh"

namespace fp32 {

// acc[i][j] += (-) sum_k A(8i + g, k) B(k, 8j + 2t + {0, 1}) over
// k < KDEPTH, with A(r, k) at A[r * A_RS + k * A_KS] and B(k, c) at
// B[k * LDB + c] (B 8-byte aligned, LDB even).
template <int MI, int NJ, int KDEPTH, int A_RS, int A_KS, int LDB, bool NEG>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][2],
                                         const float* A, const float* B) {
  const int g = dmma::lane_g(), t = dmma::lane_t();
#pragma unroll
  for (int k = 0; k < KDEPTH; ++k) {
    float a[MI];
    float2 b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      a[i] = A[(8 * i + g) * A_RS + k * A_KS];
      if (NEG) a[i] = -a[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float2*>(B + k * LDB + 8 * j + 2 * t);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j][0] = fmaf(a[i], b[j].x, acc[i][j][0]);
        acc[i][j][1] = fmaf(a[i], b[j].y, acc[i][j][1]);
      }
  }
}

}  // namespace fp32

// The product and the helpers the shared device code calls for its scalar
// type T (double: the FP64 tensor cores; float: FFMA).
namespace tile {

template <int MI, int NJ, int KD, int A_RS, int A_KS, int LDB, bool NEG>
__device__ __forceinline__ void mma(double (&acc)[MI][NJ][2],
                                    const double* A, const double* B) {
  dmma::warp_mma<MI, NJ, KD, A_RS, A_KS, LDB, NEG>(acc, A, B);
}

template <int MI, int NJ, int KD, int A_RS, int A_KS, int LDB, bool NEG>
__device__ __forceinline__ void mma(float (&acc)[MI][NJ][2], const float* A,
                                    const float* B) {
  fp32::warp_mma<MI, NJ, KD, A_RS, A_KS, LDB, NEG>(acc, A, B);
}

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
