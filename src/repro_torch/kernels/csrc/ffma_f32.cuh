// FP32 building block of the port's f32 stepped SYRK tile
// (stepped_syrk.cuh, which the stepped SYRK and the SYRK half of the fused
// kernels run), and the product that tile calls for either scalar type.
// Sm_90a. The f32 TRSM core runs 3xTF32 instead (tf32x3_f32.cuh).
//
// The TPU kernels accumulate sub-f64 inputs in f32; so does this product,
// on plain FFMA, not on the TF32 tensor cores (a 3xTF32 SYRK tile is
// queued; one TF32 product would land about 1e-3 from the f32 plain
// version).
//
// fp32::warp_mma() keeps the fragment layout of dmma::warp_mma() (lane
// 4g + t owns rows 8i + g and columns 8j + 2t + {0, 1} of the warp tile), so
// the staging, accumulator loads and stores of the shared device code serve
// both types; only the product differs. Per k a lane loads MI values of A
// (one per row it owns; lanes of equal g read the same word, a broadcast)
// and NJ float2 of B (lanes of equal t read the same pair), then issues
// 2 MI NJ FFMA in a fixed order: each output sums over k in order, in f32.
//
// Shared-memory banks for 4-byte words: the SYRK tile reads both operands
// (its k-major Y panels) as contiguous runs of one row, so the padding
// chosen for 8-byte words serves here too.
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

// The SYRK tile's product for its scalar type T (double: the FP64 tensor
// cores; float: FFMA).
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

}  // namespace tile
