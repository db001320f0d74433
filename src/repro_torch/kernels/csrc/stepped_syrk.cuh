// Device half of the stepped SYRK, shared by the stepped SYRK kernel
// (stepped_syrk.cu) and the fused TRSM->SYRK kernels
// (stepped_trsm_syrk.cu). Sm_90a; scalar type T = double or float.
//
// syrk_tile<T, Load, TM, WM, WN, NTHREADS>() computes one TM x TM sub-tile of
// F = Y^T Y for one subdomain: rows r0.. (columns of Y), columns c0..,
// clipped to row_end / col_end (the bm x bm tile it belongs to), reducing
// over Y rows from k_begin (the row stripe's start block, times bs) to n.
// Ys and Fs are 16-byte aligned and m and the tile bounds are multiples of
// 8: every copy moves 16 bytes, every store two elements. The products run
// on the FP64 tensor cores (dmma_f64.cuh) at f64 and on FFMA, accumulating
// in f32 (ffma_f32.cuh), at f32: each of the block's NTHREADS / 32 warps
// owns a WM x WN warp tile in the m16n8k8 fragment layout. 16-row chunks of the two Y column panels stream through a
// 3-stage cp.async ring, each panel stored k-major exactly as it lies in Y
// (leading dimension TM + 4); the last chunk is clipped to n. A diagonal
// sub-tile (r0 == c0) copies its one panel once. The Load policy picks the
// copy: the stepped SYRK reads an input (.ca), the fused kernels read a
// scratch that other blocks of the same launch wrote and must bypass L1
// (.cg); neither uses the read-only path.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_f64.cuh"
#include "ffma_f32.cuh"

namespace stepped {

constexpr int SKC = 16;            // rows of Y per staged chunk
constexpr int SYRK_STAGES = 3;
constexpr int SYRK_THREADS = 256;  // 8 warps (the stepped SYRK's block)

template <class T, int TM>
constexpr size_t syrk_smem_bytes() {
  return sizeof(T) * SYRK_STAGES * 2 * SKC * (TM + 4);
}

struct LoadInput {
  __device__ static __forceinline__ void copy16(void* dst, const void* src,
                                                bool valid) {
    dmma::cp_async_ca(dst, src, valid);
  }
};

// cache-global: served by L2, never by a possibly stale L1 line
struct LoadFromL2 {
  __device__ static __forceinline__ void copy16(void* dst, const void* src,
                                                bool valid) {
    dmma::cp_async_cg(dst, src, valid);
  }
};

// lower tile (ti, tj), tj <= ti, from its linear index ti*(ti+1)/2 + tj
__device__ __forceinline__ void lower_tile(int t, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tj = t - ti * (ti + 1) / 2;
}

// Ys (n, m) and Fs (m, m) of one subdomain; smem (16-byte aligned) holds
// syrk_smem_bytes<T, TM>(). Uniform over the block.
template <class T, class Load, int TM, int WM, int WN,
          int NTHREADS = SYRK_THREADS>
__device__ __forceinline__ void syrk_tile(const T* Ys, T* Fs, int n, int m,
                                          int k_begin, int r0, int c0,
                                          int row_end, int col_end, T* smem) {
  using P = typename tile::Pair<T>::type;
  constexpr int V = tile::VEC<T>;
  constexpr int LD = TM + 4;
  constexpr int PANEL = SKC * LD;
  constexpr int WARPS_N = TM / WN;
  static_assert(LD % 16 == 4, "conflict-free fragments");
  static_assert((TM / WM) * WARPS_N == NTHREADS / 32, "a warp tile a warp");
  constexpr int MI = WM / 8, NJ = WN / 8;

  const int tid = threadIdx.x, warp = tid / 32;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const bool diag = r0 == c0;

  T acc[MI][NJ][2];
  tile::zero(acc);
  dmma::pipeline<SYRK_STAGES>(
      (n - k_begin + SKC - 1) / SKC,
      [&](int c, int stage) {
        T* Pi = smem + stage * 2 * PANEL;
        const int k0 = k_begin + c * SKC;
        for (int idx = tid; idx < SKC * (TM / V); idx += NTHREADS) {
          const int q = idx / (TM / V), c2 = V * (idx % (TM / V));
          // rows past n (the last chunk when bs is no multiple of SKC) are
          // zero-filled
          const bool in_k = k0 + q < n;
          const T* row = Ys + (int64_t)(in_k ? k0 + q : 0) * m;
          const bool in_i = in_k && r0 + c2 < row_end;
          const bool in_j = in_k && c0 + c2 < col_end;
          Load::copy16(Pi + q * LD + c2, in_i ? row + r0 + c2 : Ys, in_i);
          if (!diag)
            Load::copy16(Pi + PANEL + q * LD + c2, in_j ? row + c0 + c2 : Ys,
                         in_j);
        }
      },
      [&](int, int stage) {
        const T* Pi = smem + stage * 2 * PANEL;
        const T* Pj = diag ? Pi : Pi + PANEL;
        // A(r, k) = Y[k][r0 + r]: k-major, like B(k, c) = Y[k][c0 + c]
        tile::mma<MI, NJ, SKC, 1, LD, LD, false>(acc, Pi + wm0, Pj + wn0);
      });

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = r0 + wm0 + 8 * i + g;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + wn0 + 8 * j + 2 * t;
      if (c < col_end)
        *reinterpret_cast<P*>(Fs + (int64_t)r * m + c) =
            tile::pair<T>(acc[i][j][0], acc[i][j][1]);
    }
  }
}

}  // namespace stepped
