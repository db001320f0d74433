// Device half of the stepped TRSM, shared by the dense and packed TRSM
// kernels (stepped_trsm.cu) and the fused TRSM->SYRK kernels
// (stepped_trsm_syrk.cu). Sm_90a, f64.
//
// solve_column_tile() runs the forward substitution of TN = 32 right-hand
// side columns of one subdomain, from its stripe's start block down:
//
//   Y[k] = Linv[k] (B[k] - sum_j L[k, j] Y[j]),  k >= start,
//
// where j walks the factor tiles of row k that the Factor accessor yields
// with j >= start (rows of Y above start are exactly zero, so skipping the
// tiles left of start is exact). Rows above start are written as zeros.
//
//   * DenseFactor: a row-major (S, n, n) factor; row k's tiles are
//     j in [start, k), leading dimension n.
//   * PackedFactor: the (S, n_blocks, bs, bs) value stack of a packed
//     factor with its CSR block index (rowptr, colidx) shared by all S;
//     row k's tiles are its stored slots t in [rowptr[k], rowptr[k+1] - 1)
//     (the diagonal slot, last in the row, is applied through Linv),
//     leading dimension bs. Absent blocks are never addressed.
//
// Each thread keeps a 4x4 register tile of the (bs x 32) accumulator;
// both operands of every product come from shared memory (4 + 4 loads per
// 16 FMAs). The factor, Linv and B are read through the read-only path
// (__ldg): no kernel writes them. Y is read with plain loads: the fused
// kernels write it in the same launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stepped {

constexpr int TN = 32;             // right-hand-side columns per block
constexpr int KC = 32;             // depth of one shared-memory chunk
constexpr int MAX_BS = 128;        // largest factor block
constexpr int THREADS = 256;       // 8 column groups x 32 row groups
constexpr int RPT = MAX_BS / 32;   // accumulator rows per thread
constexpr int CPT = TN / 8;        // accumulator columns per thread
constexpr int AS_LD = MAX_BS + 1;  // padded leading dim of a transposed A chunk

constexpr size_t TRSM_SMEM_BYTES =
    sizeof(double) * (KC * AS_LD + KC * TN + MAX_BS * TN);

struct DenseFactor {
  const double* L;  // (S, n, n)
  int n;

  __device__ __forceinline__ int first(int k, int start) const { return start; }
  __device__ __forceinline__ int last(int k) const { return k; }
  __device__ __forceinline__ int col(int it) const { return it; }
  __device__ __forceinline__ int64_t ld(int bs) const { return n; }
  __device__ __forceinline__ const double* tile(int64_t s, int k, int it,
                                                int bs) const {
    return L + s * (int64_t)n * n + (int64_t)k * bs * n + (int64_t)it * bs;
  }
};

struct PackedFactor {
  const double* values;  // (S, n_blocks, bs, bs)
  const int* rowptr;     // (nb + 1,)
  const int* colidx;     // (n_blocks,)
  int n_blocks;

  __device__ __forceinline__ int first(int k, int start) const {
    return __ldg(rowptr + k);
  }
  // the diagonal slot is the last of its row: stop before it
  __device__ __forceinline__ int last(int k) const {
    return __ldg(rowptr + k + 1) - 1;
  }
  __device__ __forceinline__ int col(int it) const { return __ldg(colidx + it); }
  __device__ __forceinline__ int64_t ld(int bs) const { return bs; }
  __device__ __forceinline__ const double* tile(int64_t s, int k, int it,
                                                int bs) const {
    return values + (s * n_blocks + it) * (int64_t)bs * bs;
  }
};

// As[q][r] = A[r][kc0 + q] for r < bs, q < KC (A row-major, leading dim lda)
__device__ __forceinline__ void load_a_chunk(double* As, const double* A,
                                             int64_t lda, int bs, int kc0,
                                             int tid) {
  for (int idx = tid; idx < bs * KC; idx += THREADS) {
    const int r = idx / KC, q = idx % KC;
    As[q * AS_LD + r] = __ldg(A + (int64_t)r * lda + kc0 + q);
  }
}

// acc[i][c] += sign * sum_q As[q][row_i] * Bm[q * ldb + col_c]
template <bool SUBTRACT>
__device__ __forceinline__ void chunk_product(double (&acc)[RPT][CPT],
                                              const double* As,
                                              const double* Bm, int ldb,
                                              int bs, int tx, int ty) {
#pragma unroll 4
  for (int q = 0; q < KC; ++q) {
    double b[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) b[c] = Bm[q * ldb + tx + 8 * c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (ty + 32 * i < bs) {
        const double a = As[q * AS_LD + ty + 32 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (SUBTRACT) acc[i][c] -= a * b[c];
          else acc[i][c] += a * b[c];
        }
      }
    }
  }
}

// Columns [col0, col0 + TN) of subdomain s. Linv (S, nb, bs, bs), B and Y
// (S, n, m) row-major; smem holds TRSM_SMEM_BYTES. Every loop bound is
// uniform over the block, so the barriers inside are reached by all.
template <class Factor>
__device__ __forceinline__ void solve_column_tile(
    const Factor& fac, const double* Linv, const double* B, double* Y,
    int64_t s, int col0, int start, int n, int m, int bs, double* smem) {
  double* As = smem;             // [KC][AS_LD] transposed chunk of L or Linv
  double* Bs = As + KC * AS_LD;  // [KC][TN]    chunk of solved Y rows
  double* Cs = Bs + KC * TN;     // [MAX_BS][TN] right side of the diagonal step

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int nb = n / bs;
  const double* Bsub = B + s * (int64_t)n * m;
  const double* Linvs = Linv + s * (int64_t)nb * bs * bs;
  double* Ys = Y + s * (int64_t)n * m;

  // rows above the stripe's first block are structurally zero
  for (int idx = tid; idx < start * bs * TN; idx += THREADS) {
    const int r = idx / TN, c = idx % TN;
    Ys[(int64_t)r * m + col0 + c] = 0.0;
  }

  for (int k = start; k < nb; ++k) {
    double acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 32 * i;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[i][c] = r < bs
            ? __ldg(Bsub + (int64_t)(k * bs + r) * m + col0 + tx + 8 * c)
            : 0.0;
    }

    // acc -= L[k, j] Y[j] over the factor tiles of row k with j >= start
    const int last = fac.last(k);
    for (int it = fac.first(k, start); it < last; ++it) {
      const int j = fac.col(it);
      if (j < start) continue;  // Y[j] is zero: the product is exactly 0
      const double* Lkj = fac.tile(s, k, it, bs);
      for (int kc0 = 0; kc0 < bs; kc0 += KC) {
        load_a_chunk(As, Lkj, fac.ld(bs), bs, kc0, tid);
        for (int idx = tid; idx < KC * TN; idx += THREADS) {
          const int q = idx / TN, c = idx % TN;
          Bs[q * TN + c] = Ys[(int64_t)(j * bs + kc0 + q) * m + col0 + c];
        }
        __syncthreads();
        chunk_product<true>(acc, As, Bs, TN, bs, tx, ty);
        __syncthreads();
      }
    }

    // diagonal step: Y[k] = Linv[k] acc
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 32 * i;
      if (r < bs) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) Cs[r * TN + tx + 8 * c] = acc[i][c];
      }
    }
    double out[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) out[i][c] = 0.0;
    const double* Lkk_inv = Linvs + (int64_t)k * bs * bs;
    for (int kc0 = 0; kc0 < bs; kc0 += KC) {
      load_a_chunk(As, Lkk_inv, bs, bs, kc0, tid);
      __syncthreads();
      chunk_product<false>(out, As, Cs + kc0 * TN, TN, bs, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 32 * i;
      if (r < bs) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          Ys[(int64_t)(k * bs + r) * m + col0 + tx + 8 * c] = out[i][c];
      }
    }
    // Y[k] is read back by this block's later rows
    __syncthreads();
  }
}

}  // namespace stepped
