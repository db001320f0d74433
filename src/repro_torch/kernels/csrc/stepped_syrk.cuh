// Device half of the stepped SYRK, shared by the stepped SYRK kernel
// (stepped_syrk.cu) and the fused TRSM->SYRK kernels
// (stepped_trsm_syrk.cu). Sm_90a; scalar type T = double or float.
//
// syrk_tile<T, Load, TM, WM, WN, NTHREADS>() computes one TM x TM sub-tile of
// F = Y^T Y for one subdomain: rows r0.. (columns of Y), columns c0..,
// clipped to row_end / col_end, reducing over Y rows from the start of the
// stripe of row r0 to n. The region may span several bm-wide stripes (the
// groups of stripes of the stepped SYRK and of the fused kernels); entry
// (r, c) takes the terms of Y rows k >= start(r), the start of r's own
// stripe, as the TPU kernel's tile does,
// and is stored only where c's stripe is at or before r's (a stripe pair
// (i, j <= i)): the rest keeps the zeros the wrapper allocated. To that end
// every staged element of the row panel is zero-filled (cp.async with
// src-size 0) where its Y row lies above its own column's stripe start, so
// each product sums exactly the terms k >= start(r). A diagonal region
// (r0 == c0) stages its one panel once and uses it on both sides; there the
// column side's own mask drops nothing more, because starts are
// non-decreasing (start(c) <= start(r) for every stored entry). A warp
// whose rows all lie in stripes starting past a chunk skips its products
// for that chunk (its A operand would be zeros).
//
// Ys and Fs are 16-byte aligned and m and the region's bounds are multiples
// of 8 (bm is): every copy moves 16 bytes of one stripe, every store two
// elements of one stripe. The products run on the FP64 tensor cores
// (dmma_f64.cuh) at f64 and 3xTF32 on the TF32 tensor cores, each k8 step's
// three products summed in a fresh accumulator and joined to the running
// sum by round-to-nearest f32 adds (tf32x3_f32.cuh), at f32: each of the
// block's NTHREADS / 32 warps owns a WM x WN warp tile in the m16n8k8
// fragment layout. SYRK_KC-row chunks of the two Y column panels stream
// through a 3-stage cp.async ring, each panel stored k-major exactly as it
// lies in Y (leading dimension SYRK_LD: conflict-free fragments for either
// type); the last chunk is clipped to n. The Load policy picks the copy:
// the stepped SYRK reads an input (.ca), the fused kernels read a scratch
// that other blocks of the same launch wrote and must bypass L1 (.cg);
// neither uses the read-only path.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_f64.cuh"
#include "tf32x3_f32.cuh"

namespace stepped {

// rows of Y per staged chunk: 32 in the f32 stepped SYRK's 128-wide regions
// (6-9% faster than 16 at feti-heat-3d's Dirichlet stage, within 4% either
// way at the other shapes; PERF.md), else 16
template <class T, int TM>
constexpr int SYRK_KC = sizeof(T) == 4 && TM == 128 ? 32 : 16;
constexpr int SYRK_STAGES = 3;
constexpr int SYRK_THREADS = 256;  // 8 warps (the stepped SYRK's block)
// a panel's leading dimension: fragments hit bank 4g + t (mod 16) of
// 8-byte words at 4 (mod 16) doubles, bank 8t + g of 4-byte words at
// 8 (mod 32) floats
template <class T, int TM>
constexpr int SYRK_LD = sizeof(T) == 8 ? TM + 4 : TM + 8;
static_assert(SYRK_LD<double, 128> % 16 == 4 && SYRK_LD<double, 64> % 16 == 4 &&
                  SYRK_LD<float, 128> % 32 == 8 && SYRK_LD<float, 64> % 32 == 8,
              "conflict-free fragments");

template <class T, int TM>
constexpr size_t syrk_smem_bytes() {
  return sizeof(T) * SYRK_STAGES * 2 * SYRK_KC<T, TM> * SYRK_LD<T, TM>;
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

// Stripes a group of a TM-wide region takes: the most whole bm-wide
// stripes in TM columns when bm < TM, else one stripe, cut into TM x TM
// sub-tiles. A group is group_stripes<TM>(bm) * bm columns wide.
template <int TM>
__host__ __device__ __forceinline__ int group_stripes(int bm) {
  return bm < TM ? TM / bm : 1;
}

// The stripes of one launch: column x of Y (row or column x of F) lies in
// stripe x / bm, whose terms start at Y row start(x) (n for an empty one).
struct Stripes {
  const int* start_block;  // (m / bm,), non-decreasing
  int bs, bm, nb;
  __device__ __forceinline__ int stripe(int x) const { return x / bm; }
  __device__ __forceinline__ int start(int x) const {
    return min(start_block[x / bm], nb) * bs;
  }
};

// Ys (n, m) and Fs (m, m) of one subdomain; smem (16-byte aligned) holds
// syrk_smem_bytes<T, TM>(). Uniform over the block.
template <class T, class Load, int TM, int WM, int WN,
          int NTHREADS = SYRK_THREADS>
__device__ __forceinline__ void syrk_tile(const T* Ys, T* Fs, int n, int m,
                                          const Stripes& st, int r0, int c0,
                                          int row_end, int col_end, T* smem) {
  using P = typename tile::Pair<T>::type;
  constexpr int V = tile::VEC<T>;
  constexpr int KC = SYRK_KC<T, TM>;
  constexpr int LD = SYRK_LD<T, TM>;
  constexpr int PANEL = KC * LD;
  constexpr int WARPS_N = TM / WN;
  constexpr int ROW_V = TM / V;  // 16-byte vectors per panel row
  static_assert((TM / WM) * WARPS_N == NTHREADS / 32, "a warp tile a warp");
  static_assert(NTHREADS % ROW_V == 0 && KC * ROW_V % NTHREADS == 0,
                "each thread copies one panel column, whole chunks a pass");
  constexpr int MI = WM / 8, NJ = WN / 8;

  const int tid = threadIdx.x, warp = tid / 32;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const bool diag = r0 == c0;
  const int k_begin = st.start(r0);  // the smallest start of the region
  // the copy column of this thread, and the first Y row its row-panel
  // vector may take (n: none; past row_end the vector is zeros)
  const int c2 = V * (tid % ROW_V), q0 = tid / ROW_V;
  const bool in_i = r0 + c2 < row_end, in_j = c0 + c2 < col_end;
  const int k_i = in_i ? st.start(r0 + c2) : n;
  // the first Y row at which this warp's A operand (its rows' row-panel
  // columns) can be nonzero
  const int k_warp = r0 + wm0 < row_end ? st.start(r0 + wm0) : n;

  T acc[MI][NJ][2];
  tile::zero(acc);
  dmma::pipeline<SYRK_STAGES>(
      (n - k_begin + KC - 1) / KC,
      [&](int c, int stage) {
        T* Pi = smem + stage * 2 * PANEL;
        const int k0 = k_begin + c * KC;
#pragma unroll
        for (int p = 0; p < KC * ROW_V / NTHREADS; ++p) {
          const int q = q0 + p * (NTHREADS / ROW_V), k = k0 + q;
          // rows past n (the last chunk when bs is no multiple of KC) are
          // zero-filled
          const bool in_k = k < n;
          const T* row = Ys + (int64_t)(in_k ? k : 0) * m;
          const bool vi = k >= k_i && in_k;
          const bool vj = in_j && in_k;
          Load::copy16(Pi + q * LD + c2, vi ? row + r0 + c2 : Ys, vi);
          if (!diag)
            Load::copy16(Pi + PANEL + q * LD + c2, vj ? row + c0 + c2 : Ys,
                         vj);
        }
      },
      [&](int c, int stage) {
        const T* Pi = smem + stage * 2 * PANEL;
        const T* Pj = diag ? Pi : Pi + PANEL;
        // A(r, k) = Y[k][r0 + r]: k-major, like B(k, c) = Y[k][c0 + c]
        if (k_begin + (c + 1) * KC > k_warp)
          tile::mma<MI, NJ, KC, 1, LD, LD, false>(acc, Pi + wm0, Pj + wn0);
      });

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = r0 + wm0 + 8 * i + g;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + wn0 + 8 * j + 2 * t;
      if (c < col_end && st.stripe(c) <= st.stripe(r))
        *reinterpret_cast<P*>(Fs + (int64_t)r * m + c) =
            tile::pair<T>(acc[i][j][0], acc[i][j][1]);
    }
  }
}

}  // namespace stepped
