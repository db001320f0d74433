// Device half of the stepped SYRK, shared by the stepped SYRK kernel
// (stepped_syrk.cu) and the fused TRSM->SYRK kernels
// (stepped_trsm_syrk.cu). Sm_90a, f64.
//
// syrk_subtile() computes one 32 x 32 sub-tile of F = Y^T Y for one
// subdomain: rows r0.. (columns of Y in the row stripe), columns c0..,
// reducing over Y rows from k_begin (the row stripe's start block, times
// bs) to n. It streams 32-row chunks of the two Y column panels through
// shared memory; each thread keeps 4 outputs. The Load policy reads Y:
// the stepped SYRK reads an input, the fused kernels read a scratch that
// other blocks of the same launch wrote, and must bypass L1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stepped {

constexpr int T = 32;          // output sub-tile edge
constexpr int SKC = 32;        // rows of Y per shared-memory chunk
constexpr int SYRK_THREADS = 256;  // 32 output rows x 8 column groups
constexpr int SYRK_CPT = T / 8;    // outputs per thread

constexpr size_t SYRK_SMEM_BYTES = sizeof(double) * (SKC * (T + 1) + SKC * T);

struct LoadInput {
  __device__ static __forceinline__ double load(const double* p) { return *p; }
};

// cache-global: served by L2, never by a possibly stale L1 line
struct LoadFromL2 {
  __device__ static __forceinline__ double load(const double* p) {
    return __ldcg(p);
  }
};

// lower tile (ti, tj), tj <= ti, from its linear index ti*(ti+1)/2 + tj
__device__ __forceinline__ void lower_tile(int t, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tj = t - ti * (ti + 1) / 2;
}

// Ys (n, m) and Fs (m, m) of one subdomain; smem holds SYRK_SMEM_BYTES.
template <class Load>
__device__ __forceinline__ void syrk_subtile(const double* Ys, double* Fs,
                                             int n, int m, int k_begin,
                                             int r0, int c0, double* smem) {
  double (*Yi)[T + 1] = reinterpret_cast<double (*)[T + 1]>(smem);
  double (*Yj)[T] = reinterpret_cast<double (*)[T]>(smem + SKC * (T + 1));
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  double acc[SYRK_CPT];
#pragma unroll
  for (int c = 0; c < SYRK_CPT; ++c) acc[c] = 0.0;

  for (int k0 = k_begin; k0 < n; k0 += SKC) {
    for (int idx = tid; idx < SKC * T; idx += SYRK_THREADS) {
      const int q = idx / T, c = idx % T;
      const bool in = k0 + q < n;
      const int64_t row = (int64_t)(k0 + q) * m;
      Yi[q][c] = in ? Load::load(Ys + row + r0 + c) : 0.0;
      Yj[q][c] = in ? Load::load(Ys + row + c0 + c) : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < SKC; ++q) {
      const double a = Yi[q][ty];
#pragma unroll
      for (int c = 0; c < SYRK_CPT; ++c) acc[c] += a * Yj[q][tx + 8 * c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < SYRK_CPT; ++c)
    Fs[(int64_t)(r0 + ty) * m + c0 + tx + 8 * c] = acc[c];
}

}  // namespace stepped
